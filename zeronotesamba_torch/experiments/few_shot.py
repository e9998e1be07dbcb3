"""Few-shot beat tracking experiment (data_exp.py equivalent).

Port of zeronotesamba_tpu/experiments/few_shot.py. Training-set size sweep
with repeated seeded splits (reference data_exp.py:14-179): sizes
[1,2,3,4,6,8,12,16,24,32,48,64,96], 10 repeats each, 6/8-1/8-1/8 splits
shuffled with random.Random(16), with the JAX experiment's split semantics and
random streams.
"""

from __future__ import annotations

import random
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from zeronotesamba_torch.data.datasets import BeatDataset
from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, _clone_params
from zeronotesamba_torch.train.supervised import StagedDataset, SupervisedConfig, init_state, run_epoch
from zeronotesamba_torch.utils.logging import get_logger

log = get_logger("experiments.few_shot")

REFERENCE_TRAIN_SIZES = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96)


def few_shot_splits(names: Sequence[str], split_seed: int = 16):
    """(pool, val_names, test_names): ONE Random(split_seed) shuffle of all
    songs, then test and val FIXED for the whole sweep (the last 1/8 and the
    7th 1/8), the first 6/8 the train pool (reference data_exp.py:47-53)."""
    names = list(names)
    random.Random(split_seed).shuffle(names)
    cv_len = len(names) / 8
    return names[0 : round(cv_len * 6)], names[round(cv_len * 6) : round(cv_len * 7)], names[round(cv_len * 7) :]


def run_few_shot(
    ds: BeatDataset,
    cfg: BeatExperimentConfig,
    *,
    train_sizes: Sequence[int] = REFERENCE_TRAIN_SIZES,
    repeats: int = 10,
    split_seed: int = 16,  # reference data_exp.py:47
    init_params: Optional[Mapping] = None,
    on_size_done=None,
    device: str | torch.device = "cuda",
) -> Dict[int, Dict[str, float]]:
    sup_cfg = SupervisedConfig(
        status=cfg.status, pre=cfg.pre, lr=cfg.lr, eval_method=cfg.eval_method,
        batch_size=cfg.batch_size, bucket_frames=cfg.bucket_frames, dropout_seed=cfg.seed,
        pos_weight=cfg.pos_weight, compute_dtype=cfg.compute_dtype,
    )
    pool, val_names, test_names = few_shot_splits(ds.names, split_seed)
    staged = StagedDataset(ds.records, cfg.bucket_frames, device=device)
    results: Dict[int, Dict[str, float]] = {}

    for size in train_sizes:
        f1s: List[float] = []
        for rep in range(repeats):
            # Only the train POOL is reshuffled each repeat (reference
            # data_exp.py:78): a fresh Random(split_seed) applied to the
            # pool's current in-place order, so the permutations compose.
            random.Random(split_seed).shuffle(pool)
            train_names = pool[:size]

            state = init_state(sup_cfg, ds[0], cfg.seed + rep, params=init_params, device=device)
            val_plan = staged.plan(val_names, cfg.batch_size)
            # Init params are the first best-checkpoint candidate (see beat.py).
            _, _, ivm = run_epoch(state, staged, val_plan, sup_cfg, train=False, score=True)
            best_f1 = float(ivm[0])
            best_params = _clone_params(state.model)
            stale = 0
            shuffle_rng = np.random.default_rng(split_seed * 31 + rep)
            for epoch in range(cfg.max_epochs):
                tp = staged.plan(train_names, cfg.batch_size, shuffle_rng)
                state, _, _ = run_epoch(state, staged, tp, sup_cfg, train=True, epoch=epoch, score=False)
                _, _, vm = run_epoch(state, staged, val_plan, sup_cfg, train=False, score=True)
                if vm[0] > best_f1:
                    best_f1, best_params, stale = float(vm[0]), _clone_params(state.model), 0
                else:
                    stale += 1
                if stale >= cfg.patience:
                    break
            test_plan = staged.plan(test_names, cfg.batch_size)
            state.model.load_state_dict(best_params)
            _, _, tm = run_epoch(state, staged, test_plan, sup_cfg, train=False, score=True)
            f1s.append(float(tm[0]))
        results[size] = {"F1": float(np.mean(f1s)), "F1_std": float(np.std(f1s))}
        log.info("few-shot size=%d: F1=%.3f +- %.3f", size, results[size]["F1"], results[size]["F1_std"])
        if on_size_done is not None:
            # Flush partial results after every size, so a sweep cut short
            # keeps the sizes it completed.
            on_size_done(size, results[size])
    return results
