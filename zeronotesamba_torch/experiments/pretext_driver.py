"""Self-supervised pretext experiment driver (pretext.py train_model equivalent).

Port of zeronotesamba_tpu/experiments/pretext_driver.py. It orchestrates bank
building and contrastive training with the reference's schedule shape
(pretext.py:175-450): per epoch the train bank is shuffled and each track
yields one batch of ``batch_size`` random crops; validation shifts are
FIXED at epoch 0 (pretext.py:284-292); the best-validation params are
checkpointed in the reference key names (``models/shift_pret_cnn_16.pth``).

The numpy draws (the shuffle, the k-track pad, the S-chunk pad, the shifts)
come in the JAX driver's order from the same seeds, so both drivers train on
the same crops in the same order. With ``steps_per_call`` = S > 1 an
epoch's updates are padded to a multiple of S and run S to a call (one
CUDA graph on a card), their losses and cosines read once a call. Dropout
masks cannot follow JAX's streams: each update draws them from a device
generator seeded from ``seed + 1 + 1000*attempt`` and the global update
index (train/supervised.dropout_generator).

With a ``mesh`` (parallel/mesh.py) every rank runs ``train_pretext``
track-parallel, as the JAX driver does under a mesh: the bank is padded
modularly to a multiple of d and rank r holds rows [r*S, (r+1)*S) on its
device; every rank draws the same host stream (one permutation per shard,
in shard order), and each update hands rank r its k local tracks. Rank 0
alone evaluates the validation batches and the proxy F1, and broadcasts
the numbers that drive checkpoint selection, the plateau watchdog and the
resume; it alone writes checkpoints. Every rank returns the same history.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.parallel.mesh import Mesh, broadcast_scalars
from zeronotesamba_torch.train.checkpoint import CheckpointManager, save_params
from zeronotesamba_torch.train.pretext import (
    PretextConfig,
    crop_shifts,
    init_pretext_state,
    make_eval_step,
    make_staged_train_step,
    sample_shifts,
)
from zeronotesamba_torch.train.supervised import dropout_generator
from zeronotesamba_torch.utils.logging import get_logger
from zeronotesamba_torch.utils.profiling import trace

log = get_logger("experiments.pretext")


@dataclasses.dataclass
class PretextRunConfig:
    """The JAX driver's fields and defaults. ``steps_per_call`` = S > 1 pads
    each epoch's updates to a multiple of S and runs them S at a time
    (train/pretext.make_staged_train_step; single-device only: forced to 1
    under a mesh, as in JAX). Accepted with no effect: ``rng_impl`` picks
    the TPU's random-bit generator, ``scan_unroll`` the XLA lowering of the
    S-step scan, ``freq_s2d`` a TPU matrix-unit schedule whose outputs equal
    the plain conv's."""

    task: str = "zerons"
    num_epochs: int = 250
    batch_size: int = 16
    crop_frames: int = 313
    temperature: float = 0.25
    lr: float = None  # None = reference rules (train/state.pretext_learning_rate)
    compute_dtype: str = "float32"  # float32 | bfloat16 convs
    tracks_per_step: int = 1  # >1 = accumulate k per-track NT-Xent batches
    # into one update (same per-track loss semantics; sqrt(k) less gradient
    # noise: the demo-scale plateau-escape lever, see make_staged_train_step)
    steps_per_call: int = 1
    scan_unroll: bool = False
    freq_s2d: tuple = ()
    seed: int = 0
    checkpoint_path: Optional[str] = None  # best-val params, a .pth or .npz
    # (reference models/shift_pret_cnn_16.pth)
    # Checkpoint SELECTION. The reference selects on NT-Xent validation loss
    # (pretext.py:408-412); "proxy_f1" selects on zero-shot beat F1 over a
    # small labelled proxy set, evaluated every ``proxy_every`` epochs. Both
    # candidates are saved when checkpoint_path is set: the selected one at
    # checkpoint_path, the other with "_valsel" / "_proxysel" before its
    # extension (x.pth -> x_valsel.pth).
    selection: str = "val_loss"  # val_loss (reference parity) | proxy_f1
    proxy_dataset: Optional[object] = None  # BeatDataset; required for
    # proxy_f1 and optional (monitoring only) under val_loss
    proxy_every: int = 5
    proxy_eval_method: str = "dbn"
    resume_dir: Optional[str] = None  # whole-train-state checkpoints, one an
    # epoch: a run resumes after the latest with its optimizer state (the
    # reference can only save, never resume)
    figures_path: Optional[str] = None  # loss/similarity PDFs every
    # figures_every epochs (reference pretext.py:418-448); needs matplotlib
    figures_every: int = 5
    trace_dir: Optional[str] = None  # torch.profiler trace of the first epoch
    rng_impl: str = "rbg"
    # Plateau watchdog. Demo-scale NT-Xent starts pinned at the
    # ln(batch_size) constant-embedding attractor and escape is a stochastic
    # threshold event, indistinguishable from never escaping until it
    # happens. The detector is a deadline: if val loss has not dropped below
    # ln(batch_size) - plateau_margin within plateau_deadline epochs of an
    # attempt, reinit params/optimizer/shuffle streams with seed +
    # 1000*attempt and retry (up to plateau_restarts extra attempts; the last
    # attempt always runs the full num_epochs). 0 disables (reference parity).
    plateau_deadline: int = 0
    plateau_margin: float = 0.05
    plateau_restarts: int = 2


def build_bank_from_stem_root(
    stem_root: str,
    n_samples: int,
    *,
    clip_len_s: float = 10.0,
    sample_rate: int = 16000,
    lower_p: float = 0.3,
    upper_p: float = 1.0,
    seed: int = 0,
    mode: str = "vqt",
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Mine (N, 2, 96, T) VQT pairs from a new_data/-style stem directory
    (reference create_memory_bank, pretext.py:89-172), each log-VQT on
    ``device``."""
    import random

    from zeronotesamba_torch.data.separation import load_stem_dir
    from zeronotesamba_torch.data.stems import fold_stems, mine_pair
    from zeronotesamba_torch.ops.vqt import generate_xqt

    dev = resolve_device(device)
    rng = random.Random(seed)
    track_ids = sorted(os.listdir(stem_root))
    rng.shuffle(track_ids)
    bank: List[np.ndarray] = []
    for tid in track_ids:
        if len(bank) >= n_samples:
            break
        tdir = os.path.join(stem_root, tid)
        try:
            stems = load_stem_dir(tdir, target_sr=sample_rate)
            anchor, positive = fold_stems(stems)
            if len(anchor) < clip_len_s * sample_rate + 2:
                continue  # reference deletes <10 s tracks (pretext.py:120-124)
            a, p = mine_pair(anchor, positive, clip_len_s=clip_len_s, sample_rate=sample_rate,
                             lower_p=lower_p, upper_p=upper_p, rng=rng)
            bank.append(np.stack([generate_xqt(a, sample_rate, mode, device=dev),
                                  generate_xqt(p, sample_rate, mode, device=dev)]))
        except (FileNotFoundError, ValueError) as e:
            log.warning("skipping %s: %s", tid, e)
    return np.stack(bank).astype(np.float32)


def zero_shot_proxy_f1(ds, pretext_params, *, batch_size: int = 8, eval_method: str = "dbn",
                       device: str | torch.device = "cuda") -> float:
    """Zero-shot beat F1 of a twin pretext state dict (``anchor.``/``postve.``
    keys) over a labelled set: the beat-proxy selection metric
    (experiments/beat.py pre='validation', the demo grid's zero-shot arm)."""
    from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, run_beat_experiment

    res = run_beat_experiment(
        ds,
        BeatExperimentConfig(status="pretrained", pre="validation", eval_method=eval_method, batch_size=batch_size),
        init_params=pretext_params, progress=False, device=device,
    )
    return float(res[0].test_metrics[0])


def fixed_val_shifts(val_bank: np.ndarray, cfg: PretextConfig, seed: int) -> np.ndarray:
    """Pre-crop validation batches once (reference pretext.py:284-292)."""
    rng = np.random.default_rng(seed)
    return np.stack([crop_shifts(item, cfg.batch_size, cfg.crop_frames, rng) for item in val_bank])


def _other_path(path: str, tag: str) -> str:
    """``x.pth`` -> ``x<tag>.pth``: the other selection's checkpoint."""
    root, ext = os.path.splitext(path)
    return root + tag + ext


def _params(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def shard_bank(train_bank: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This rank's (S, 2, 96, T) shard of the bank padded to a multiple of d
    rows, on its device: rows [r*S, (r+1)*S) of the padded bank. The pad
    repeats the bank's rows modularly, as the JAX driver's does (a bank
    smaller than half the data axis needs more pad rows than it has). Only
    the shard's rows are read, so a memory-mapped bank is read only there."""
    n = len(train_bank)
    s = -(-n // mesh.size)
    rows = np.arange(mesh.rank * s, (mesh.rank + 1) * s) % n
    return torch.as_tensor(np.asarray(np.take(train_bank, rows, axis=0), np.float32), device=mesh.device)


def train_pretext(
    train_bank: np.ndarray,
    val_bank: np.ndarray,
    cfg: PretextRunConfig,
    *,
    mesh: Optional[Mesh] = None,
    device: str | torch.device = "cuda",
) -> "tuple":
    """Train on ``device`` (with a ``mesh``, on its device); returns (best
    params as a state dict in the reference key names, history dict). Under
    a mesh only rank 0 reads ``val_bank``; the other ranks may pass None."""
    if cfg.selection not in ("val_loss", "proxy_f1"):
        raise ValueError(f"unknown selection {cfg.selection!r} (val_loss|proxy_f1)")
    if cfg.selection == "proxy_f1" and cfg.proxy_dataset is None:
        raise ValueError("selection='proxy_f1' requires proxy_dataset")
    if cfg.selection == "proxy_f1" and cfg.task != "zerons":
        raise ValueError("proxy_f1 selection needs the twin 'zerons' pretext")
    dev = resolve_device(device if mesh is None else mesh.device)
    lead = mesh is None or mesh.rank == 0  # evaluates, decides and writes

    pcfg = PretextConfig(
        task=cfg.task, batch_size=cfg.batch_size, crop_frames=cfg.crop_frames,
        temperature=cfg.temperature, lr=cfg.lr, compute_dtype=cfg.compute_dtype,
        freq_s2d=tuple(cfg.freq_s2d),
    )
    state = init_pretext_state(pcfg, cfg.seed, device=dev)
    s_call = max(1, int(cfg.steps_per_call)) if mesh is None else 1
    step = make_staged_train_step(pcfg, mesh=mesh, steps_per_call=s_call)
    eval_step = make_eval_step(pcfg)
    rng = np.random.default_rng(cfg.seed)
    # Both banks go to the device once; a training batch is (track, shifts)
    # and one gather there (make_staged_train_step). Under a mesh each rank
    # holds its shard of the train bank, and rank 0 the validation batches.
    if mesh is None:
        bank_dev = torch.as_tensor(train_bank, dtype=torch.float32, device=dev)
    else:
        bank_dev = shard_bank(train_bank, mesh)
    val_batches = [torch.as_tensor(vb, device=dev) for vb in fixed_val_shifts(val_bank, pcfg, cfg.seed)] if lead else []
    bank_frames = train_bank.shape[-1]

    best_val = np.inf
    best_params = _params(state.model)
    best_proxy = -np.inf
    best_proxy_params = best_params
    hist = {"train_loss": [], "val_loss": [], "train_pos": [], "train_neg": [], "val_pos": [], "val_neg": []}
    if cfg.proxy_dataset is not None:
        hist["proxy_epoch"], hist["proxy_f1"] = [], []
    dropout_seed = cfg.seed + 1
    start_epoch = 0
    mgr = None
    if cfg.resume_dir:
        mgr = CheckpointManager(cfg.resume_dir)
        latest = mgr.latest_step()
        if mesh is not None:
            latest = int(broadcast_scalars([-1 if latest is None else latest], mesh)[0])
            latest = None if latest < 0 else latest
        if latest is not None:
            state = mgr.restore(state, latest)
            start_epoch = latest + 1
            log.info("resumed from epoch %d", latest)

    k = max(1, int(cfg.tracks_per_step))

    def epoch_updates() -> list:
        """Per-epoch track order as a list of updates: a track index (k = 1)
        or a (k,) index array, the last padded by tracks drawn at random.
        Under a mesh, each shard's own permutation (drawn in shard order,
        each padded to a multiple of k) laid out as (d*k,) LOCAL indices a
        update, rank i's at [i*k, (i+1)*k)."""
        if mesh is None:
            order = rng.permutation(len(train_bank))
            if k == 1:
                return list(order)
            pad = (-len(order)) % k
            if pad:
                order = np.concatenate([order, rng.choice(len(train_bank), size=pad)])
            return list(order.reshape(-1, k))
        perms = []
        shard_size = len(bank_dev)
        padk = (-shard_size) % k
        for _ in range(mesh.size):
            p_i = rng.permutation(shard_size)
            if padk:
                p_i = np.concatenate([p_i, rng.choice(shard_size, size=padk)])
            perms.append(p_i.reshape(-1, k))
        return list(np.stack(perms, axis=1).reshape(-1, mesh.size * k))

    def starts_for(i):
        if np.ndim(i) > 0:
            return np.stack([sample_shifts(bank_frames, pcfg.batch_size, pcfg.crop_frames, rng) for _ in i])
        return sample_shifts(bank_frames, pcfg.batch_size, pcfg.crop_frames, rng)

    hist["restarts"] = []  # global-epoch indices where a watchdog reinit fired
    pinned_ln = float(np.log(cfg.batch_size))
    attempts = 1 + (int(cfg.plateau_restarts) if cfg.plateau_deadline else 0)
    for attempt in range(attempts):
        if attempt:
            log.warning(
                "plateau watchdog: val pinned near ln(B)=%.4f after %d epochs; "
                "reinitializing with seed %d (attempt %d/%d)",
                pinned_ln, cfg.plateau_deadline, cfg.seed + 1000 * attempt, attempt + 1, attempts)
            state = init_pretext_state(pcfg, cfg.seed + 1000 * attempt, device=dev)
            rng = np.random.default_rng(cfg.seed + 1000 * attempt)
            dropout_seed = cfg.seed + 1 + 1000 * attempt
            hist["restarts"].append(len(hist["val_loss"]))
        a_start = start_epoch if attempt == 0 else 0
        escaped = False
        for epoch in range(a_start, cfg.num_epochs):
            tr_losses, tr_pos, tr_neg = [], [], []
            with trace(cfg.trace_dir if epoch == a_start and attempt == 0 else None):
                updates = epoch_updates()
                if s_call > 1:
                    # The JAX driver's S-chunk schedule: pad the epoch to a
                    # multiple of S with tracks drawn from the shuffle
                    # stream, then each chunk's shifts, update by update.
                    for _ in range((-len(updates)) % s_call):
                        updates.append(rng.choice(len(train_bank), size=(k,)) if k > 1
                                       else rng.integers(len(train_bank)))
                    for c in range(0, len(updates), s_call):
                        chunk = updates[c: c + s_call]
                        gens = [dropout_generator(dropout_seed, epoch * len(updates) + c + j, dev)
                                for j in range(s_call)]
                        starts = np.stack([starts_for(i) for i in chunk])
                        state, losses, pcs, ncs = step(state, bank_dev, np.asarray(chunk), starts, gens)
                        chunk_loss, chunk_pos, chunk_neg = torch.stack([losses, pcs, ncs]).tolist()
                        tr_losses.extend(chunk_loss); tr_pos.extend(chunk_pos); tr_neg.extend(chunk_neg)
                else:
                    for u, i in enumerate(updates):
                        gen = dropout_generator(dropout_seed, epoch * len(updates) + u, dev)
                        state, loss, pc, nc = step(state, bank_dev, i, starts_for(i), gen)
                        tr_losses.append(float(loss)); tr_pos.append(float(pc)); tr_neg.append(float(nc))
            va_losses, va_pos, va_neg = [], [], []
            for vb in val_batches:
                loss, pc, nc = eval_step(state, vb)
                va_losses.append(float(loss)); va_pos.append(float(pc)); va_neg.append(float(nc))
            proxy_due = cfg.proxy_dataset is not None and (
                (epoch + 1) % cfg.proxy_every == 0 or epoch == cfg.num_epochs - 1)
            pf1 = float("nan")
            if proxy_due and lead:
                pf1 = zero_shot_proxy_f1(cfg.proxy_dataset, state.model.state_dict(),
                                         eval_method=cfg.proxy_eval_method, device=dev)
            va, vpos, vneg = (float(np.mean(v)) for v in (va_losses, va_pos, va_neg)) if lead else (0.0,) * 3
            if mesh is not None:
                va, vpos, vneg, pf1 = broadcast_scalars([va, vpos, vneg, pf1], mesh)
            tr = float(np.mean(tr_losses))
            hist["train_loss"].append(tr); hist["val_loss"].append(va)
            hist["train_pos"].append(float(np.mean(tr_pos))); hist["train_neg"].append(float(np.mean(tr_neg)))
            hist["val_pos"].append(vpos); hist["val_neg"].append(vneg)
            log.info("epoch %d: train=%.4f val=%.4f pos=%.3f neg=%.3f", epoch, tr, va,
                     hist["val_pos"][-1], hist["val_neg"][-1])
            if va < pinned_ln - cfg.plateau_margin:
                escaped = True
            if va < best_val:
                best_val = va
                best_params = _params(state.model)
                if cfg.checkpoint_path and lead:
                    path = cfg.checkpoint_path
                    save_params(path if cfg.selection == "val_loss" else _other_path(path, "_valsel"), state.model)
            if proxy_due:
                hist["proxy_epoch"].append(epoch)
                hist["proxy_f1"].append(pf1)
                log.info("epoch %d: proxy zero-shot F1=%.3f (best %.3f)", epoch, pf1, max(best_proxy, pf1))
                if pf1 > best_proxy:
                    best_proxy = pf1
                    best_proxy_params = _params(state.model)
                    if cfg.checkpoint_path and lead:
                        path = cfg.checkpoint_path
                        save_params(path if cfg.selection == "proxy_f1" else _other_path(path, "_proxysel"),
                                    state.model)
            if mgr is not None and lead:
                mgr.save(epoch, state, metrics={"val_loss": va})
            if cfg.figures_path and lead and (epoch + 1) % cfg.figures_every == 0:
                from zeronotesamba_torch.utils.plotting import plot_history

                plot_history(hist, cfg.figures_path)
            if (cfg.plateau_deadline and not escaped and attempt < attempts - 1
                    and epoch - a_start + 1 >= cfg.plateau_deadline):
                break
        if escaped or attempt == attempts - 1:
            break
    if mgr is not None:
        mgr.close()
    if cfg.selection == "proxy_f1":
        return best_proxy_params, hist
    return best_params, hist
