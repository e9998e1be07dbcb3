"""Reproduce the reference's full experiment grid on synthetic data.

Port of zeronotesamba_tpu/experiments/demo_suite.py. With no Ballroom /
GTZAN / Hainsworth / SMC audio at hand, this module runs the SHAPE of every
reference experiment end to end on synthetic click-track corpora with
exactly known annotations, on ``device``:

1. pretext contrastive pretraining on percussive/harmonic stem pairs
   (reference pretext.py) -> checkpoint;
2. zero-shot evaluation of the frozen pretext model (beat_down.py
   'validation' mode) vs a random-init control, with the dbn / librosa /
   threshold decoder columns and the old-school raw-audio arm
   (unsupervised.xlsx);
3. supervised k-fold CV beat tracking: vanilla, pretrained-finetune and the
   Böck-style TCN (beat_down.py / supervised.xlsx);
4. cross-dataset generalization onto a different-timbre corpus, with a
   B->B in-domain control (cross_data.py / cross_data.xlsx);
5. few-shot training-size sweeps, vanilla and pretrained (data_exp.py /
   few_shot.xlsx), and optionally the CLMR arm;
6. embedding information measures over six arms (measures.py /
   measures.xlsx).

Each stage writes JSON under ``cfg.out_dir``; ``summary.json`` has the JAX
module's key tree. The seeds, corpus knobs and arm configs are the JAX
module's; see its comments for why each value was chosen. The default
``out_dir`` is git-ignored (the JAX default, ``results/synthetic``, holds
committed evidence).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict

import numpy as np
import torch

from zeronotesamba_torch.data.datasets import BeatDataset, SongRecord
from zeronotesamba_torch.data.pulse import beat_pulse
from zeronotesamba_torch.data.synthetic import percussive_pair
from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.experiments.beat import (
    BeatExperimentConfig, run_beat_experiment, summarize, summarize_extra,
)
from zeronotesamba_torch.experiments.cross import run_cross_experiment
from zeronotesamba_torch.experiments.few_shot import run_few_shot
from zeronotesamba_torch.experiments.measures import measure_arm, write_measures_report
from zeronotesamba_torch.experiments.pretext_driver import PretextRunConfig, train_pretext
from zeronotesamba_torch.ops.vqt import generate_xqt
from zeronotesamba_torch.utils.logging import get_logger

log = get_logger("experiments.demo_suite")
FPS = 62.5


@dataclasses.dataclass
class DemoSuiteConfig:
    out_dir: str = "results/synthetic_torch"
    n_songs: int = 24
    n_songs_b: int = 16
    pretext_songs: int = 48  # unlabelled pretext corpus, larger than corpus A
    duration_s: float = 12.0
    pretext_epochs: int = 60
    pretext_accum: int = 1  # tracks averaged per pretext update
    folds: int = 4
    max_epochs: int = 100
    patience: int = 35  # rides out the ~45-50 epoch BCE plateau of these corpora
    batch_size: int = 8
    pos_weight: float = 8.0  # ~1/positive-rate class balancing (losses/bce.py)
    pretext_lr: float = 3e-6
    few_shot_sizes: tuple = (1, 2, 3, 4, 6, 8, 12)
    few_shot_repeats: int = 5
    few_shot_max_epochs: int = 300
    pretext_selection: str = "proxy_f1"  # proxy_f1 | val_loss (reference parity)
    proxy_songs: int = 6  # disjoint labelled proxy set for proxy_f1 selection
    pretext_plateau_deadline: int = 0  # 0 = auto: the full pretext budget;
    # negative disables the watchdog (reference parity)
    clmr: bool = False  # also run the CLMR-style pretext + finetune arm
    difficulty: float = 1.0  # scales every corpus difficulty knob; 0 = clean corpora
    seed: int = 0


def _build_corpus(n: int, duration_s: float, *, bpm_lo: float, bpm_hi: float,
                  freq_lo: float, freq_hi: float, seed: int, difficulty: float = 1.0,
                  device: str | torch.device = "cuda"):
    """Paired datasets over the SAME songs: split (anchor/positive) + mix,
    and the mixes' waveforms. Every song draws its own percussive
    fundamental (log-uniform in [freq_lo, freq_hi], 5 harmonics) and its own
    difficulty knobs, scaled by ``difficulty``: timing jitter, tempo drift,
    dynamics and ghost beats, off-beat distractor hits, syncopated harmonic
    spikes, stem bleed and a raised noise floor. The log-VQTs run on
    ``device``."""
    rng = np.random.default_rng(seed)
    d = float(difficulty)
    split = BeatDataset()
    mix = BeatDataset()
    wavs = []
    for i in range(n):
        bpm = float(rng.uniform(bpm_lo, bpm_hi))
        freq = float(np.exp(rng.uniform(np.log(freq_lo), np.log(freq_hi))))
        anchor, positive, beats = percussive_pair(
            duration_s, bpm, seed=seed * 10007 + i, harmonics=5, click_freq=freq,
            jitter_s=d * float(rng.uniform(0.008, 0.025)),
            drift=d * float(rng.uniform(0.02, 0.06)),
            amp_sd=d * 0.35,
            drop_p=d * 0.45,
            offbeat=d * float(rng.uniform(0.5, 1.2)),
            offbeat_p=0.85,
            offbeat_swing=d * 0.12,
            offbeat_accent=1.0 + d * float(rng.uniform(0.0, 1.2)),
            burst=d * 0.6,
            harm_offbeat=d * 0.45,
            harm_depth=0.4 - d * float(rng.uniform(0.0, 0.15)),
            bleed=d * 0.08,
            noise=0.002 + d * 0.01,
        )
        vq_a = generate_xqt(anchor, 16000, "vqt", device=device)
        vq_p = generate_xqt(positive, 16000, "vqt", device=device)
        vq_m = generate_xqt((anchor + positive).astype(np.float32), 16000, "vqt", device=device)
        t = vq_a.shape[-1]
        pulse = beat_pulse(beats, t, FPS)
        name = f"s{seed}_{i:03d}_bpm{bpm:.0f}"
        common = dict(
            pulse=pulse, down_pulse=np.zeros(t, np.float32),
            beat_times=np.asarray(beats), downbeat_times=np.zeros(0),
        )
        split.add(SongRecord(name=name, vqt=np.stack([vq_a, vq_p]), **common))
        mix.add(SongRecord(name=name, vqt=vq_m[None], **common))
        wavs.append((anchor + positive).astype(np.float32))
    return split, mix, wavs


def _metrics_dict(summary: Dict[str, float]) -> Dict[str, float]:
    return {k: round(v, 4) for k, v in summary.items()}


def run_demo_suite(cfg: DemoSuiteConfig, device: str | torch.device = "cuda") -> Dict[str, dict]:
    """Every stage in order on ``device``; returns the summary it writes to
    ``<out_dir>/summary.json``."""
    device = resolve_device(device)
    os.makedirs(cfg.out_dir, exist_ok=True)
    results: Dict[str, dict] = {}
    t_start = time.time()
    corpus = dict(difficulty=cfg.difficulty, device=device)

    log.info("building corpora...")
    # Corpus A ~ "GTZAN": a wide per-song kit range (700-2800 Hz). Corpus
    # B ~ "Ballroom": a darker kit family (550-1050 Hz), shifted tempos.
    split_a, mix_a, wavs_a = _build_corpus(cfg.n_songs, cfg.duration_s, bpm_lo=70, bpm_hi=180,
                                           freq_lo=700.0, freq_hi=2800.0, seed=cfg.seed + 1, **corpus)
    _, mix_b, _ = _build_corpus(cfg.n_songs_b, cfg.duration_s, bpm_lo=60, bpm_hi=140,
                                freq_lo=550.0, freq_hi=1050.0, seed=cfg.seed + 2, **corpus)

    # 1. Pretext pretraining on a larger unlabelled corpus from corpus A's
    # seed stream (its first n_songs are corpus A's songs: transductive SSL).
    log.info("pretext pretraining (%d unlabeled songs, transductive)...", cfg.pretext_songs)
    split_u, _, _ = _build_corpus(cfg.pretext_songs, cfg.duration_s, bpm_lo=70, bpm_hi=180,
                                  freq_lo=700.0, freq_hi=2800.0, seed=cfg.seed + 1, **corpus)
    bank = np.stack([r.vqt for r in split_u]).astype(np.float32)
    n_val = max(2, len(bank) // 8)
    proxy_ds = None
    if cfg.pretext_selection == "proxy_f1":
        # Disjoint seed stream: selection never reads corpus A itself.
        proxy_ds, _, _ = _build_corpus(cfg.proxy_songs, cfg.duration_s, bpm_lo=70, bpm_hi=180,
                                       freq_lo=700.0, freq_hi=2800.0, seed=cfg.seed + 77, **corpus)
    deadline = cfg.pretext_plateau_deadline
    if deadline == 0:
        deadline = cfg.pretext_epochs  # auto: restart only a budget-exhausted pinned run
    pre_cfg = PretextRunConfig(task="zerons", num_epochs=cfg.pretext_epochs, batch_size=16, seed=cfg.seed,
                               lr=cfg.pretext_lr, tracks_per_step=cfg.pretext_accum,
                               checkpoint_path=os.path.join(cfg.out_dir, "pretext_ckpt.pth"),
                               selection=cfg.pretext_selection, proxy_dataset=proxy_ds,
                               plateau_deadline=max(0, deadline))
    best_params, hist = train_pretext(bank[n_val:], bank[:n_val], pre_cfg, device=device)
    results["pretext"] = {
        "val_loss_first": round(hist["val_loss"][0], 4),
        "val_loss_best": round(min(hist["val_loss"]), 4),
        "val_pos_final": round(hist["val_pos"][-1], 4),
        "val_neg_final": round(hist["val_neg"][-1], 4),
        "selection": cfg.pretext_selection,
        "watchdog_restarts": hist.get("restarts", []),
    }
    if cfg.pretext_selection == "proxy_f1" and hist.get("proxy_f1"):
        results["pretext"]["proxy_f1_best"] = round(max(hist["proxy_f1"]), 4)
    # The twin's state dict: FusedDownstream loads it into its pretext twin.
    fused_params = best_params

    # 2. Zero-shot (validation mode): pretrained vs random init, with the
    # dbn / librosa-DP / threshold columns, and the old-school arm (spectral
    # flux -> Ellis DP on the raw mixes, no learning).
    log.info("zero-shot eval...")
    zcfg = BeatExperimentConfig(status="pretrained", pre="validation", eval_method="dbn",
                                batch_size=cfg.batch_size, seed=cfg.seed,
                                extra_eval_methods=("librosa", "threshold"))
    zs_pre = run_beat_experiment(split_a, zcfg, init_params=fused_params, device=device)
    zs_rand = run_beat_experiment(split_a, zcfg, init_params=None, device=device)
    from zeronotesamba_torch.decode.ellis import beat_track_signal
    from zeronotesamba_torch.metrics.beat import evaluate_beats

    old_school = np.stack([
        evaluate_beats(rec.beat_times, beat_track_signal(wav))
        for rec, wav in zip(mix_a.records, wavs_a)
    ])
    results["unsupervised"] = {
        "zerons_dbn_f1": round(float(zs_pre[0].test_metrics[0]), 4),
        "zerons_librosa_f1": round(float(zs_pre[0].extra_metrics["librosa"][0]), 4),
        "zerons_threshold_f1": round(float(zs_pre[0].extra_metrics["threshold"][0]), 4),
        "random_dbn_f1": round(float(zs_rand[0].test_metrics[0]), 4),
        "random_librosa_f1": round(float(zs_rand[0].extra_metrics["librosa"][0]), 4),
        "old_school_f1": round(float(old_school[:, 0].mean()), 4),
        "old_school_cmlt": round(float(old_school[:, 2].mean()), 4),
    }

    # 3. Supervised k-fold CV: vanilla (mix input), pretrained finetune and
    # the Böck TCN, each with the decoder columns; the vanilla and Böck
    # folds keep their best params for the measures table.
    log.info("supervised CV (vanilla)...")
    bcfg = BeatExperimentConfig(status="vanilla", lr=2e-4, eval_method="dbn", n_folds=cfg.folds,
                                max_epochs=cfg.max_epochs, patience=cfg.patience,
                                batch_size=cfg.batch_size, pos_weight=cfg.pos_weight, seed=cfg.seed,
                                extra_eval_methods=("librosa", "threshold"))
    res_van = run_beat_experiment(mix_a, dataclasses.replace(bcfg, return_params=True), progress=False,
                                  device=device)
    log.info("supervised CV (pretrained finetune)...")
    pcfg = dataclasses.replace(bcfg, status="pretrained", lr=2e-3)  # eff lr = 0.05*lr rule
    res_pre = run_beat_experiment(split_a, pcfg, init_params=fused_params, progress=False, device=device)
    log.info("supervised CV (Böck TCN baseline)...")
    kcfg = dataclasses.replace(bcfg, status="bock", lr=5e-4, return_params=True)
    res_bock = run_beat_experiment(mix_a, kcfg, progress=False, device=device)
    results["supervised"] = {
        "vanilla": _metrics_dict(summarize(res_van)),
        "pretrained": _metrics_dict(summarize(res_pre)),
        "bock_tcn": _metrics_dict(summarize(res_bock)),
        "by_decoder": {
            "vanilla": {m: _metrics_dict(t) for m, t in summarize_extra(res_van).items()},
            "pretrained": {m: _metrics_dict(t) for m, t in summarize_extra(res_pre).items()},
            "bock_tcn": {m: _metrics_dict(t) for m, t in summarize_extra(res_bock).items()},
        },
        "bock_tcn_note": (
            "Böck-STYLE TCN trained here on this corpus — a capability "
            "stand-in for madmom's pretrained RNNBeatProcessor "
            "(reference measures.py:270-277), whose published weights are "
            "not available in this environment; the column measures the "
            "architecture class, not the published checkpoint."
        ),
    }

    # 4. Cross-dataset: corpus A -> corpus B, with a B->B in-domain control,
    # at 2 folds and a deeper budget than the CV stage.
    log.info("cross-dataset...")
    ccfg = dataclasses.replace(bcfg, n_folds=2, max_epochs=max(150, cfg.max_epochs))
    res_cross = run_cross_experiment(mix_a, mix_b, ccfg, device=device)
    log.info("cross-dataset in-domain control (B->B)...")
    res_b_ctrl = run_beat_experiment(mix_b, ccfg, progress=False, device=device)
    results["cross_data"] = {
        "a_to_b": _metrics_dict(summarize(res_cross)),
        "b_in_domain": _metrics_dict(summarize(res_b_ctrl)),
    }

    # 5. Few-shot sweep on corpus A: vanilla and pretrained arms.
    log.info("few-shot (vanilla)...")
    fcfg = dataclasses.replace(bcfg, max_epochs=cfg.few_shot_max_epochs)
    res_few_van = run_few_shot(mix_a, fcfg, train_sizes=cfg.few_shot_sizes, repeats=cfg.few_shot_repeats,
                               device=device)
    log.info("few-shot (pretrained)...")
    fcfg_pre = dataclasses.replace(fcfg, status="pretrained", lr=2e-3)
    res_few_pre = run_few_shot(
        split_a, fcfg_pre, train_sizes=cfg.few_shot_sizes, repeats=cfg.few_shot_repeats,
        init_params=fused_params, device=device,
    )
    results["few_shot"] = {
        "vanilla": {str(k): v for k, v in res_few_van.items()},
        "pretrained": {str(k): v for k, v in res_few_pre.items()},
    }
    with open(os.path.join(cfg.out_dir, "few_shot_comparison.json"), "w") as fh:
        json.dump(results["few_shot"], fh, indent=2)

    # 5b. Optional CLMR arm: same-mix two-crop pretext (reference
    # fma_loader.gen_clmr) + supervised CV.
    if cfg.clmr:
        log.info("clmr pretext + finetune...")
        cl_bank = np.stack([np.concatenate([r.vqt, r.vqt], axis=0) for r in mix_a]).astype(np.float32)
        n_val_c = max(2, len(cl_bank) // 8)
        cl_cfg = PretextRunConfig(task="clmr", num_epochs=cfg.pretext_epochs, batch_size=16,
                                  lr=cfg.pretext_lr, seed=cfg.seed,
                                  checkpoint_path=os.path.join(cfg.out_dir, "clmr_ckpt.pth"))
        cl_params, cl_hist = train_pretext(cl_bank[n_val_c:], cl_bank[:n_val_c], cl_cfg, device=device)
        clcfg = dataclasses.replace(bcfg, status="clmr", lr=2e-4)
        res_clmr = run_beat_experiment(mix_a, clcfg, init_params=cl_params, progress=False, device=device)
        results["clmr"] = {
            "pretext_val_best": round(min(cl_hist["val_loss"]), 4),
            "supervised": _metrics_dict(summarize(res_clmr)),
        }

    # 6. Embedding measures over the reference's arms (measures.py:341-473).
    # One run_id stamps every arm; the first write truncates the files.
    log.info("measures (multi-arm)...")
    run_id = f"demo_suite_seed{cfg.seed}_{time.strftime('%Y%m%d')}"
    arms = [
        ("zerons_mix", split_a, "pretrained", fused_params, "fused"),
        ("zerons_ros", split_a, "pretrained", fused_params, "anchor"),
        ("zerons_drums", split_a, "pretrained", fused_params, "positive"),
        ("random", split_a, "pretrained", None, "fused"),
        ("vanilla", mix_a, "vanilla", res_van[-1].best_params, "fused"),
        ("bock", mix_a, "bock", res_bock[-1].best_params, "fused"),
    ]
    results["measures"] = {}
    for i, (label, ds_arm, status, params_arm, stream) in enumerate(arms):
        table = measure_arm(ds_arm, status, params_arm, stream=stream, batch_size=cfg.batch_size, device=device)
        write_measures_report(table, os.path.join(cfg.out_dir, "measures"), label,
                              run_id=run_id, fresh=(i == 0))
        results["measures"][label] = {k: round(v["mean"], 4) for k, v in table.items()}

    results["wall_clock_s"] = round(time.time() - t_start, 1)
    with open(os.path.join(cfg.out_dir, "summary.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    log.info("demo suite done in %.0fs -> %s", results["wall_clock_s"], cfg.out_dir)
    return results
