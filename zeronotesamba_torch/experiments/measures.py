"""Embedding information measures (reference measures.py equivalents).

Port of zeronotesamba_tpu/experiments/measures.py: the numpy measures and
the report are copied; ``measure_arm`` runs the port's model on ``device``.

Sparsity/information statistics over per-frame embedding pulses
(reference measures.py:119-182): L2/L1 ratio, Gini coefficient, kurtosis,
Shannon entropy, approximate entropy, sample entropy, and the maximum
autocorrelation in the 0.24-1.0 s lag window (the beat-periodicity band).
Results are aggregated as quantile tables (0.1/0.25/0.5/0.75/0.9/mean) and
written as CSV/JSON plus a real ``.xlsx`` workbook: openpyxl is unavailable
in this image, so the appender of reference measures.py:33-116 is rebuilt on
the stdlib writer in utils/xlsx.py (same append-below-last-row semantics).
"""

from __future__ import annotations

import csv
import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

QUANTILES = (0.1, 0.25, 0.5, 0.75, 0.9)


def l2_l1_ratio(x: np.ndarray) -> float:
    l1 = np.abs(x).sum()
    return float(np.sqrt((x**2).sum()) / l1) if l1 > 0 else 0.0


def gini(x: np.ndarray) -> float:
    """Gini sparsity coefficient (Hurley & Rickard 2009)."""
    v = np.sort(np.abs(np.asarray(x, dtype=np.float64)))
    n = v.size
    total = v.sum()
    if total == 0 or n == 0:
        return 0.0
    k = np.arange(1, n + 1)
    return float(1.0 - 2.0 * np.sum(v / total * (n - k + 0.5) / n))


def kurtosis(x: np.ndarray) -> float:
    v = np.asarray(x, dtype=np.float64)
    m = v.mean()
    s2 = ((v - m) ** 2).mean()
    if s2 == 0:
        return 0.0
    return float((((v - m) ** 4).mean()) / s2**2 - 3.0)


def shannon_entropy(x: np.ndarray, bins: int = 100) -> float:
    v = np.abs(np.asarray(x, dtype=np.float64))
    if v.size == 0 or v.max() == 0:
        return 0.0
    hist, _ = np.histogram(v, bins=bins)
    p = hist / hist.sum()
    p = p[p > 0]
    return float(-(p * np.log2(p)).sum())


def _phi(x: np.ndarray, m: int, r: float, count_self: bool) -> float:
    n = len(x)
    if n <= m + 1:
        return 0.0
    emb = np.lib.stride_tricks.sliding_window_view(x, m)
    d = np.max(np.abs(emb[:, None, :] - emb[None, :, :]), axis=-1)
    if count_self:
        c = (d <= r).mean(axis=1)
        return float(np.log(np.maximum(c, 1e-12)).mean())
    np.fill_diagonal(d, np.inf)
    return float((d <= r).sum())


def approximate_entropy(x: np.ndarray, m: int = 2, r_factor: float = 0.2) -> float:
    v = np.asarray(x, dtype=np.float64)
    if len(v) < m + 2:
        return 0.0
    r = r_factor * v.std()
    return abs(_phi(v, m, r, True) - _phi(v, m + 1, r, True))


def sample_entropy(x: np.ndarray, m: int = 2, r_factor: float = 0.2) -> float:
    v = np.asarray(x, dtype=np.float64)
    if len(v) < m + 2:
        return 0.0
    r = r_factor * v.std()
    a = _phi(v, m + 1, r, False)
    b = _phi(v, m, r, False)
    if a == 0 or b == 0:
        return 0.0
    return float(-np.log(a / b))


def max_beat_autocorrelation(x: np.ndarray, fps: float = 62.5, lag_lo_s: float = 0.24, lag_hi_s: float = 1.0) -> float:
    """Max normalized autocorrelation within the tempo lag band
    (reference measures.py:158-166)."""
    v = np.asarray(x, dtype=np.float64)
    v = v - v.mean()
    denom = (v * v).sum()
    if denom == 0:
        return 0.0
    n = len(v)
    fft_n = int(2 ** np.ceil(np.log2(2 * n)))
    spec = np.fft.rfft(v, fft_n)
    ac = np.fft.irfft(spec * np.conj(spec), fft_n)[:n] / denom
    lo = max(1, int(round(lag_lo_s * fps)))
    hi = min(n - 1, int(round(lag_hi_s * fps)))
    if hi <= lo:
        return 0.0
    return float(ac[lo : hi + 1].max())


MEASURES = {
    "l2_l1": l2_l1_ratio,
    "gini": gini,
    "kurtosis": kurtosis,
    "shannon": shannon_entropy,
    "app_entropy": approximate_entropy,
    "samp_entropy": sample_entropy,
    "max_acf": max_beat_autocorrelation,
}


def embedding_measures(pulse: np.ndarray, *, downsample_entropy: int = 4) -> Dict[str, float]:
    """All measures for one per-frame pulse/embedding vector.

    Sensitivity note: the O(T^2) app/sample entropies
    run on a 4x-strided copy by default, which CHANGES the measured quantity
    vs the reference (antropy on the full 62.5 fps pulse, measures.py:158-166)
    — absolute levels shift (direction depends on the signal: a clean
    periodic pulse reads HIGHER at stride 4, white noise lower) while the
    cross-arm ORDERING is preserved (checked at stride 1 vs 4 on synthetic
    clean/noisy/random pulses: app 0.23/1.50/2.01 -> 0.66/1.39/1.44, samp
    0.19/1.39/2.20 -> 0.89/1.77/2.17 — same ranking both strides).
    Pass ``downsample_entropy=1`` for reference-faithful absolute values;
    comparisons across arms within one report are stride-consistent either
    way. The report writer stamps the stride used (entropy_stride) so readers
    can tell which quantity a table carries.
    """
    out = {}
    for name, fn in MEASURES.items():
        if name in ("app_entropy", "samp_entropy"):
            out[name] = fn(pulse[::downsample_entropy])
        else:
            out[name] = fn(pulse)
    return out


def quantile_table(rows: Sequence[Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """Per-measure quantiles + mean over a corpus of embedding measures."""
    table: Dict[str, Dict[str, float]] = {}
    for name in MEASURES:
        vals = np.asarray([r[name] for r in rows], dtype=np.float64)
        entry = {f"q{q}": float(np.quantile(vals, q)) for q in QUANTILES}
        entry["mean"] = float(vals.mean())
        table[name] = entry
    return table


def write_measures_report(
    table: Dict[str, Dict[str, float]],
    out_path: str,
    label: str,
    *,
    run_id: str | None = None,
    fresh: bool = False,
):
    """Write/merge the quantile table into <out>.json and <out>.csv.

    Every row is stamped with a ``run_id`` (default: today's date) so
    regenerations are distinguishable; ``fresh=True`` truncates both files
    first, so regenerations do not pile up identically labelled rows; a
    multi-arm run calls this with ``fresh=True`` on its first arm and shares
    one run_id across the rest.
    """
    import datetime

    run_id = run_id or datetime.date.today().isoformat()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    # entropy_stride: see embedding_measures — app/samp entropy absolute
    # levels depend on the stride; stamp it so readers know the quantity.
    doc: Dict = {"run_id": run_id, "entropy_stride": 4, "arms": {}}
    if not fresh and os.path.exists(out_path + ".json"):
        with open(out_path + ".json") as fh:
            prev = json.load(fh)
        if prev.get("run_id") == run_id and "arms" in prev:
            doc = prev
        elif "arms" in prev:
            # A different run_id without fresh=True must not silently drop
            # the earlier run while the CSV keeps appending it: demote the
            # old run into previous_runs so both artifacts carry the same
            # provenance.
            doc["previous_runs"] = prev.pop("previous_runs", {})
            doc["previous_runs"][prev.get("run_id", "unknown")] = prev["arms"]
    doc["arms"][label] = table
    with open(out_path + ".json", "w") as fh:
        json.dump(doc, fh, indent=2)
    new = fresh or not os.path.exists(out_path + ".csv")
    with open(out_path + ".csv", "w" if fresh else "a", newline="") as fh:
        w = csv.writer(fh)
        if new:
            w.writerow(["run_id", "label", "measure"] + [f"q{q}" for q in QUANTILES] + ["mean"])
        for name, entry in table.items():
            w.writerow([run_id, label, name] + [entry[f"q{q}"] for q in QUANTILES] + [entry["mean"]])
    # xlsx twin of the CSV (reference measures.py:33-116 append_df_to_excel):
    # append the same rows below the sheet's last row; fresh truncates.
    from zeronotesamba_torch.utils.xlsx import append_rows

    xlsx_path = out_path + ".xlsx"
    if fresh and os.path.exists(xlsx_path):
        os.remove(xlsx_path)
    header = [["run_id", "label", "measure"] + [f"q{q}" for q in QUANTILES] + ["mean"]] \
        if fresh or not os.path.exists(xlsx_path) else []
    append_rows(
        xlsx_path,
        header + [
            [run_id, label, name] + [entry[f"q{q}"] for q in QUANTILES] + [entry["mean"]]
            for name, entry in table.items()
        ],
        sheet_name="measures",
    )


def measure_arm(
    ds,
    status: str,
    params=None,
    *,
    stream: str = "fused",
    batch_size: int = 8,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> Dict[str, Dict[str, float]]:
    """Quantile table of embedding measures for one model arm over a dataset.

    The reference's measures workbook is a COMPARISON across modes —
    pretrained drums/ros/mix vs vanilla vs random vs Böck (measures.py:341-473,
    mode-specific startrows :535-617); this helper produces one such column.
    ``stream`` selects the fused/anchor/positive pulse for pretrained twins
    (reference 'mix'/'ros'/'drums'); the per-stream pulses are the sigmoid of
    ``FusedDownstream.logits``.
    """
    from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, eval_step, init_state

    cfg = SupervisedConfig(status=status, batch_size=batch_size)
    state = init_state(cfg, ds[0], seed, params=params, device=device)
    staged = StagedDataset(ds.records, cfg.bucket_frames, device=device)
    which = None
    if stream != "fused" and status == "pretrained":
        which = 0 if stream in ("anchor", "ros") else 1
        state.model.eval()

    rows: List[Dict[str, float]] = []
    for t, idx in staged.plan(ds.names, batch_size):
        bucket = staged.buckets[t]
        sel = torch.as_tensor(idx, dtype=torch.int64, device=bucket.vqt.device)
        vqt_sel = bucket.vqt.index_select(0, sel)
        if which is not None:
            with torch.no_grad():
                out = torch.sigmoid(state.model.logits(vqt_sel[:, 0:1], vqt_sel[:, 1:2])[which])
        else:
            _, out = eval_step(state, vqt_sel, bucket.pulse.index_select(0, sel), bucket.mask.index_select(0, sel),
                               status)
        out = out.cpu().numpy()
        for b, row in enumerate(idx):
            rows.append(embedding_measures(out[b, : bucket.n_frames[row]]))
    return quantile_table(rows)
