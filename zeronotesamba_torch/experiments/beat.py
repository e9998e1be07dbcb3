"""8-fold cross-validated beat-tracking experiment (beat_down.py equivalent).

Port of zeronotesamba_tpu/experiments/beat.py. Workflow parity with the
reference driver (beat_down.py:17-304):

- shuffle songs, split into 8 folds (reference beat_down.py:50-63), with the
  JAX package's ``random.Random`` use, so a seed gives the same splits;
- per fold: fresh model/optimizer via the status/pre/lr rules, train up to
  ``max_epochs`` with early stopping after ``patience`` non-improving
  validation F1 epochs (beat_down.py:101-151), keep the best-val params,
  evaluate them on the held-out fold (beat_down.py:153-191);
- ``pre == 'validation'``: zero-shot evaluation of the (pretrained, frozen)
  model over the entire set (beat_down.py:221-283);
- report mean +- std over folds for all six metrics.

Everything runs on ``device`` (the card by default).
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from zeronotesamba_torch.data.datasets import BeatDataset
from zeronotesamba_torch.train.supervised import (
    StagedDataset,
    SupervisedConfig,
    init_state,
    run_epoch,
)
from zeronotesamba_torch.utils.logging import get_logger

log = get_logger("experiments.beat")
METRIC_NAMES = ["F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain"]


@dataclasses.dataclass
class BeatExperimentConfig:
    status: str = "vanilla"  # vanilla | pretrained | clmr | bock (TCN baseline, models/baseline.py)
    pre: str = "finetune"  # finetune | frozen | validation
    lr: float = 1e-5
    eval_method: str = "dbn"
    n_folds: int = 8
    max_epochs: int = 500
    patience: int = 20
    batch_size: int = 8
    bucket_frames: int = 128
    seed: int = 0
    pos_weight: float = 1.0  # positive-class BCE weight (losses/bce.py)
    score_train: bool = False  # the reference scores beats inside the train
    # loop every epoch (epochs.py:83-91); off by default for speed
    extra_eval_methods: tuple = ()  # additionally score the held-out fold
    # with these decoders (the reference publishes dbn vs threshold vs
    # librosa-DP columns side by side)
    return_params: bool = False  # keep each fold's best params on the result
    compute_dtype: str = "float32"  # float32 | bfloat16 convs
    steps_per_call: int = 1  # K > 1: K train steps a call (SupervisedConfig)
    freq_s2d: tuple = ()  # accepted, no effect (SupervisedConfig)


@dataclasses.dataclass
class FoldResult:
    fold: int
    test_metrics: np.ndarray  # (6,)
    best_val_f1: float
    epochs_run: int
    extra_metrics: Optional[Dict[str, np.ndarray]] = None  # decoder -> (6,)
    best_params: Optional[Dict[str, torch.Tensor]] = None  # only when cfg.return_params
    seconds: float = 0.0  # host clock over the fold, init to test scoring


def _folds(names: List[str], n_folds: int, rng: random.Random) -> List[List[str]]:
    names = list(names)
    rng.shuffle(names)
    cv_len = len(names) / n_folds
    return [
        names[round(cv_len * i) : round(cv_len * (i + 1)) if i < n_folds - 1 else len(names)]
        for i in range(n_folds)
    ]


def _clone_params(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_beat_experiment(
    ds: BeatDataset,
    cfg: BeatExperimentConfig,
    *,
    init_params: Optional[Mapping] = None,
    progress: bool = True,
    device: str | torch.device = "cuda",
) -> List[FoldResult]:
    sup_cfg = SupervisedConfig(
        status=cfg.status,
        pre=cfg.pre if cfg.pre in ("finetune", "frozen") else "frozen",
        lr=cfg.lr,
        eval_method=cfg.eval_method,
        batch_size=cfg.batch_size,
        bucket_frames=cfg.bucket_frames,
        dropout_seed=cfg.seed,
        pos_weight=cfg.pos_weight,
        compute_dtype=cfg.compute_dtype,
        steps_per_call=cfg.steps_per_call,
        freq_s2d=tuple(cfg.freq_s2d),
    )

    staged = StagedDataset(ds.records, cfg.bucket_frames, device=device)  # on the device, once

    def _extra_scores(state, plan) -> Optional[Dict[str, np.ndarray]]:
        if not cfg.extra_eval_methods:
            return None
        out = {}
        for m in cfg.extra_eval_methods:
            cfg_m = dataclasses.replace(sup_cfg, eval_method=m)
            _, _, mm = run_epoch(state, staged, plan, cfg_m, train=False, score=True)
            out[m] = mm
        return out

    if cfg.pre == "validation":
        # Zero-shot: evaluate the provided (pretrained) params over everything.
        state = init_state(sup_cfg, ds[0], cfg.seed, params=init_params, device=device)
        plan = staged.plan(ds.names, cfg.batch_size)
        _, loss, metrics = run_epoch(state, staged, plan, sup_cfg, train=False, score=True)
        log.info("zero-shot: loss=%.4f F1=%.3f", loss, metrics[0])
        return [FoldResult(0, metrics, float(metrics[0]), 0,
                           extra_metrics=_extra_scores(state, plan),
                           best_params=_clone_params(state.model) if cfg.return_params else None)]

    rng = random.Random(cfg.seed)
    splits = _folds(ds.names, cfg.n_folds, rng)
    results: List[FoldResult] = []

    for fold in range(cfg.n_folds):
        t_fold = time.perf_counter()
        test_names = splits[fold]
        train_names = [n for i, s in enumerate(splits) if i != fold for n in s]
        rng.shuffle(train_names)
        # One fold's worth of the REMAINING songs as validation (reference
        # semantics at 8 folds: 6/8 train, 1/8 val, 1/8 test); deriving it
        # from the total would leave no training songs at n_folds=2.
        n_val = max(1, round(len(train_names) / cfg.n_folds))
        val_names, train_names = train_names[:n_val], train_names[n_val:]
        if not train_names:
            raise ValueError(f"fold {fold}: no training songs left (n={len(ds.names)}, folds={cfg.n_folds})")

        state = init_state(sup_cfg, ds[0], cfg.seed + fold, params=init_params, device=device)
        val_plan = staged.plan(val_names, cfg.batch_size)
        test_plan = staged.plan(test_names, cfg.batch_size)

        # The INITIAL params are the first best-checkpoint candidate, so a
        # pretrained fold never ends below its own zero-shot quality (the
        # first epochs pull outputs toward the all-zeros base rate).
        _, _, init_metrics = run_epoch(state, staged, val_plan, sup_cfg, train=False, score=True)
        best_f1 = float(init_metrics[0])
        best_params = _clone_params(state.model)
        stale = 0
        epoch = -1
        shuffle_rng = np.random.default_rng(cfg.seed * 1000 + fold)
        for epoch in range(cfg.max_epochs):
            train_plan = staged.plan(train_names, cfg.batch_size, shuffle_rng=shuffle_rng)
            state, tr_loss, _ = run_epoch(
                state, staged, train_plan, sup_cfg, train=True, epoch=epoch, score=cfg.score_train
            )
            _, val_loss, val_metrics = run_epoch(state, staged, val_plan, sup_cfg, train=False, score=True)
            if val_metrics[0] > best_f1:
                best_f1 = float(val_metrics[0])
                best_params = _clone_params(state.model)
                stale = 0
            else:
                stale += 1
            if progress:
                log.info(
                    "fold %d epoch %d: train_loss=%.4f val_loss=%.4f val_f1=%.3f best=%.3f stale=%d",
                    fold, epoch, tr_loss, val_loss, val_metrics[0], best_f1, stale,
                )
            if stale >= cfg.patience:
                break

        state.model.load_state_dict(best_params)
        _, _, test_metrics = run_epoch(state, staged, test_plan, sup_cfg, train=False, score=True)
        log.info("fold %d: test F1=%.3f (best val %.3f, %d epochs)", fold, test_metrics[0], best_f1, epoch + 1)
        results.append(FoldResult(fold, test_metrics, best_f1, epoch + 1,
                                  extra_metrics=_extra_scores(state, test_plan),
                                  best_params=best_params if cfg.return_params else None,
                                  seconds=time.perf_counter() - t_fold))

    summarize(results)
    return results


def summarize_extra(results: Sequence[FoldResult]) -> Dict[str, Dict[str, float]]:
    """Per-decoder mean/std over folds for the extra_eval_methods columns."""
    out: Dict[str, Dict[str, float]] = {}
    if not results or not results[0].extra_metrics:
        return out
    for m in results[0].extra_metrics:
        arr = np.stack([r.extra_metrics[m] for r in results])
        out[m] = {}
        for i, n in enumerate(METRIC_NAMES):
            out[m][n] = float(arr[:, i].mean())
            out[m][n + "_std"] = float(arr[:, i].std())
    return out


def summarize(results: Sequence[FoldResult]) -> Dict[str, float]:
    metrics = np.stack([r.test_metrics for r in results])
    out = {}
    for i, n in enumerate(METRIC_NAMES):
        out[n] = float(metrics[:, i].mean())
        out[n + "_std"] = float(metrics[:, i].std())
        log.info("%s: %.3f +- %.3f", n, out[n], out[n + "_std"])
    return out
