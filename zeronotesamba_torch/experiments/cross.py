"""Cross-dataset generalization experiment (cross_data.py equivalent).

Port of zeronotesamba_tpu/experiments/cross.py. Train 8 folds on one
dataset (SMC / Ballroom / Hainsworth), test every fold on the full GTZAN set
(reference cross_data.py:15-206): per fold the model trains with early
stopping on a validation split of the train dataset, then the best-val
params are evaluated on all of the test set. The folds, the validation
split and the shuffles draw from the JAX experiment's random streams, so a seed
gives the same songs in every role.
"""

from __future__ import annotations

import random
import time
from typing import List, Mapping, Optional

import numpy as np
import torch

from zeronotesamba_torch.data.datasets import BeatDataset
from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, FoldResult, _clone_params, _folds, summarize
from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, run_epoch
from zeronotesamba_torch.utils.logging import get_logger

log = get_logger("experiments.cross")


def run_cross_experiment(
    train_ds: BeatDataset,
    test_ds: BeatDataset,
    cfg: BeatExperimentConfig,
    *,
    init_params: Optional[Mapping] = None,
    device: str | torch.device = "cuda",
) -> List[FoldResult]:
    sup_cfg = SupervisedConfig(
        status=cfg.status, pre=cfg.pre, lr=cfg.lr, eval_method=cfg.eval_method,
        batch_size=cfg.batch_size, bucket_frames=cfg.bucket_frames, dropout_seed=cfg.seed,
        pos_weight=cfg.pos_weight,
    )
    rng = random.Random(cfg.seed)
    splits = _folds(train_ds.names, cfg.n_folds, rng)
    staged_train = StagedDataset(train_ds.records, cfg.bucket_frames, device=device)
    staged_test = StagedDataset(test_ds.records, cfg.bucket_frames, device=device)
    test_plan = staged_test.plan(test_ds.names, cfg.batch_size)
    results: List[FoldResult] = []

    for fold in range(cfg.n_folds):
        t_fold = time.perf_counter()
        train_names = [n for i, s in enumerate(splits) if i != fold for n in s]
        rng.shuffle(train_names)
        # Val = one fold's worth of the remaining songs (see beat.py).
        n_val = max(1, round(len(train_names) / cfg.n_folds))
        val_names, train_names = train_names[:n_val], train_names[n_val:]
        if not train_names:
            raise ValueError(f"fold {fold}: no training songs left (folds={cfg.n_folds})")

        state = init_state(sup_cfg, train_ds[0], cfg.seed + fold, params=init_params, device=device)
        val_plan = staged_train.plan(val_names, cfg.batch_size)

        # Init params are the first best-checkpoint candidate (see beat.py).
        _, _, ivm = run_epoch(state, staged_train, val_plan, sup_cfg, train=False, score=True)
        best_f1 = float(ivm[0])
        best_params = _clone_params(state.model)
        stale, epoch = 0, -1
        shuffle_rng = np.random.default_rng(cfg.seed * 977 + fold)
        for epoch in range(cfg.max_epochs):
            tp = staged_train.plan(train_names, cfg.batch_size, shuffle_rng)
            state, _, _ = run_epoch(state, staged_train, tp, sup_cfg, train=True, epoch=epoch, score=False)
            _, _, vm = run_epoch(state, staged_train, val_plan, sup_cfg, train=False, score=True)
            if vm[0] > best_f1:
                best_f1, best_params, stale = float(vm[0]), _clone_params(state.model), 0
            else:
                stale += 1
            if stale >= cfg.patience:
                break

        state.model.load_state_dict(best_params)
        _, _, tm = run_epoch(state, staged_test, test_plan, sup_cfg, train=False, score=True)
        log.info("cross fold %d: test F1=%.3f", fold, tm[0])
        results.append(FoldResult(fold, tm, best_f1, epoch + 1, seconds=time.perf_counter() - t_fold))

    summarize(results)
    return results
