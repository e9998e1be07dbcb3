"""Render the committed evidence JSONs as the reference's six results workbooks.

Port of zeronotesamba_tpu/experiments/report_xlsx.py. The reference
publishes its results as six Excel workbooks ({beat_tracking, cross_data,
few_shot, measures, supervised, unsupervised}.xlsx); :func:`export` renders
the JSON evidence of a results directory (``results/synthetic/*.json``, or
a ``demo-suite`` run's output) into workbooks with the same six filenames,
through the stdlib writer in ``utils/xlsx.py``. Host only: no model, no
device.

CLI: ``python -m zeronotesamba_torch export-xlsx --src DIR --out DIR``.
"""

from __future__ import annotations

import json
import os

from zeronotesamba_torch.utils.xlsx import write_xlsx

METRICS = ["F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain"]
METRIC_HEADER = [m for name in METRICS for m in (name, name + "_std")]


def _load(src: str, name: str):
    path = os.path.join(src, name)
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def _metric_cells(rec: dict) -> list:
    return [rec.get(k) for name in METRICS for k in (name, name + "_std")]


def build_unsupervised(src: str):
    rows = [["corpus A zero-shot (synthetic click corpus; reference "
             "unsupervised.xlsx rows are Ballroom/GTZAN/Hainsworth/SMC)"],
            ["seed", "arm", "F1"]]
    for name, seed in [("summary.json", 0), ("summary_seed1.json", 1),
                       ("summary_seed1_watchdog.json", "1+watchdog")]:
        doc = _load(src, name)
        if not doc or "unsupervised" not in doc:
            continue
        for arm, val in doc["unsupervised"].items():
            rows.append([seed, arm, val])
    return {"unsupervised": rows} if len(rows) > 2 else None


def build_supervised(src: str):
    doc = _load(src, "supervised_cv8.json")
    if not doc:
        return None
    rows = [["8-fold supervised CV, full budget (reference supervised.xlsx; "
             "north star G20=0.875)"],
            ["seed", "arm"] + METRIC_HEADER + ["n_folds"]]
    for seed, arms in doc.get("per_seed", {}).items():
        for arm, rec in arms.items():
            if isinstance(rec, dict) and "F1" in rec:
                rows.append([int(seed), arm] + _metric_cells(rec)
                            + [rec.get("n_folds", doc.get("n_folds"))])
    for arm, rec in doc.get("pooled", {}).items():
        rows.append(["pooled", arm, rec.get("F1"), rec.get("F1_std")]
                    + [None] * (len(METRIC_HEADER) - 2) + [rec.get("n")])
    fb = _load(src, "fullbudget_cv8.json")
    if fb and "pretrained_fullbudget" in fb:
        rows.append([0, f"pretrained_fullbudget({fb.get('pretext_epochs')}ep,"
                        f"{fb.get('selection')})"]
                    + _metric_cells(fb["pretrained_fullbudget"]) + [None])
    return {"supervised_cv8": rows}


def build_cross_data(src: str):
    rows = [["cross-dataset transfer A->B vs in-domain B (reference "
             "cross_data.xlsx)"],
            ["seed", "direction"] + METRIC_HEADER]
    for name, seed in [("summary.json", 0), ("summary_seed1.json", 1)]:
        doc = _load(src, name)
        if not doc or "cross_data" not in doc:
            continue
        for direction, rec in doc["cross_data"].items():
            if isinstance(rec, dict) and "F1" in rec:
                rows.append([seed, direction] + _metric_cells(rec))
    return {"cross_data": rows} if len(rows) > 2 else None


def build_few_shot(src: str):
    doc = _load(src, "few_shot_comparison.json")
    if not doc:
        return None
    sizes = sorted({int(k) for arm in ("vanilla", "pretrained")
                    for k in doc.get(arm, {})})
    rows = [[f"few-shot F1 vs labeled-song count "
             f"(repeats={doc.get('repeats')}, n_songs={doc.get('n_songs')}, "
             f"max_epochs={doc.get('max_epochs')}; reference few_shot.xlsx)"],
            ["n_labeled", "vanilla_F1", "vanilla_std",
             "pretrained_F1", "pretrained_std"]]
    for size in sizes:
        v = doc.get("vanilla", {}).get(str(size), {})
        p = doc.get("pretrained", {}).get(str(size), {})
        rows.append([size, v.get("F1"), v.get("F1_std"),
                     p.get("F1"), p.get("F1_std")])
    return {"few_shot": rows}


def build_measures(src: str):
    doc = _load(src, "measures.json")
    if not doc:
        return None
    quantile_keys = None
    rows = None
    for label, table in doc.get("arms", {}).items():
        for measure, entry in table.items():
            if quantile_keys is None:
                quantile_keys = list(entry)
                rows = [["embedding information measures "
                         f"(run {doc.get('run_id')}, entropy_stride="
                         f"{doc.get('entropy_stride', 4)}; reference "
                         "measures.xlsx)"],
                        ["label", "measure"] + quantile_keys]
            rows.append([label, measure] + [entry.get(k) for k in quantile_keys])
    return {"measures": rows} if rows else None


def build_beat_tracking(src: str):
    doc = _load(src, "summary.json")
    if not doc or "supervised" not in doc:
        return None
    sup = doc["supervised"]
    rows = [["demo-grid supervised arms + per-decoder breakdown (reference "
             "beat_tracking.xlsx)"],
            ["arm", "decoder"] + METRIC_HEADER]
    for arm, rec in sup.items():
        if isinstance(rec, dict) and "F1" in rec:
            rows.append([arm, "dbn"] + _metric_cells(rec))
    for arm, decoders in sup.get("by_decoder", {}).items():
        if not isinstance(decoders, dict):
            continue
        for dec, rec in decoders.items():
            if isinstance(rec, dict) and "F1" in rec:
                rows.append([arm, dec] + _metric_cells(rec))
            elif isinstance(rec, (int, float)):
                rows.append([arm, dec, rec] + [None] * (len(METRIC_HEADER) - 1))
    return {"beat_tracking": rows} if len(rows) > 2 else None


BUILDERS = {
    "unsupervised.xlsx": build_unsupervised,
    "supervised.xlsx": build_supervised,
    "cross_data.xlsx": build_cross_data,
    "few_shot.xlsx": build_few_shot,
    "measures.xlsx": build_measures,
    "beat_tracking.xlsx": build_beat_tracking,
}


def export(src: str = "results/synthetic", out: str = "results/synthetic_torch/xlsx") -> dict:
    """Build every workbook whose source JSONs exist; returns a manifest.

    The default ``out`` is git-ignored: the JAX package's default,
    ``results/synthetic/xlsx``, holds committed workbooks."""
    os.makedirs(out, exist_ok=True)
    written, skipped = [], []
    for fname, builder in BUILDERS.items():
        sheets = builder(src)
        if sheets is None:
            skipped.append(fname)
            continue
        write_xlsx(os.path.join(out, fname), sheets)
        written.append(fname)
    return {"written": written, "skipped": skipped, "out": out}
