"""Downstream supervised beat-tracking engine (device-resident, bucketed).

Port of zeronotesamba_tpu/train/supervised.py. In place of the reference's
per-song B=1 loop (epochs.py:8-187):

- songs are padded into length buckets and staged on the device once as
  (N, S, 96, T) tensors; every epoch then batches by index gathers on the
  device, so shuffling moves a few bytes instead of spectrograms;
- one train step per batch: masked logits-space BCE (losses/bce.py) and an
  Adam update (train/state.py);
- beat decoding + metric scoring (the reference runs madmom's DBN inside the
  train loop, epochs.py:83-91) happen on the host from the batched outputs.

Dropout: each train step draws its masks from a generator on the device,
seeded from ``dropout_seed`` and the JAX engine's per-step offset
``epoch * 100003 + i`` (``dropout_generator``), so a seeded run repeats its
masks exactly. A step without a generator runs with dropout off, as the JAX
step does with ``dropout_rng=None``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from zeronotesamba_torch.data.datasets import SongRecord
from zeronotesamba_torch.decode import decode as decode_beats_fn
from zeronotesamba_torch.device import disable_tf32, resolve_device
from zeronotesamba_torch.losses.bce import masked_bce_logits, masked_bce_twin_logits
from zeronotesamba_torch.metrics.beat import evaluate_beats
from zeronotesamba_torch.models.encoder import DSCNN, FusedDownstream
from zeronotesamba_torch.models.weights import load_weights
from zeronotesamba_torch.train.state import TrainState, make_optimizer

FPS = 62.5
PAD_VALUE = float(np.log(1e-9))  # the log-VQT silence floor
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class SupervisedConfig:
    """The JAX engine's fields. ``rng_impl`` (which TPU random-bit generator
    draws dropout), ``steps_per_call`` (how many optimizer steps the JAX
    engine fuses into one dispatched program, to hide a fixed per-call relay
    cost; its numerics are the sequential steps'), ``scan_unroll`` (how XLA
    lowers that multi-step scan) and ``freq_s2d`` (a TPU matrix-unit schedule
    for some convs, whose outputs equal the plain conv's) are accepted and
    have no effect here: every train step is one ``train_step`` call."""

    status: str = "vanilla"  # vanilla | pretrained | clmr | bock
    pre: str = "finetune"  # finetune | frozen
    lr: float = 1e-5
    eval_method: str = "dbn"  # dbn | librosa | threshold
    batch_size: int = 8
    bucket_frames: int = 128  # pad T to multiples of this
    dropout_seed: int = 0
    pos_weight: float = 1.0  # positive-class BCE weight; 1.0 = reference
    # parity (plain BCELoss, loader.py:16), ~1/positive-rate removes the
    # all-zeros plateau attractor (losses/bce.py)
    compute_dtype: str = "float32"  # float32 | bfloat16: the convs' dtype;
    # params and loss stay float32
    rng_impl: str = "rbg"
    steps_per_call: int = 1
    scan_unroll: bool = False
    freq_s2d: Tuple[int, ...] = ()


def make_model(status: str, compute_dtype="float32", freq_s2d: Tuple[int, ...] = ()):
    dt = DTYPES[compute_dtype] if isinstance(compute_dtype, str) else compute_dtype
    if status == "pretrained":
        return FusedDownstream(compute_dtype=dt, freq_s2d=tuple(freq_s2d))
    if status == "bock":
        raise NotImplementedError(
            "status 'bock' (the BockTCN baseline, models/baseline.py) is not ported yet "
            "(ROADMAP 'Modules to port', item 11)"
        )
    return DSCNN(compute_dtype=dt)


def init_state(
    cfg: SupervisedConfig,
    example: SongRecord,
    seed: int,
    params: Optional[Mapping] = None,
    *,
    device: str | torch.device = "cuda",
) -> TrainState:
    """A fresh model and optimizer on ``device``: He-normal weights drawn on
    the CPU from ``seed`` (the same weights on every device), or a copy of
    ``params`` (a state dict or Flax tree, models/weights.load_weights).
    ``example`` is accepted for the JAX signature; the model needs no shape."""
    del example
    dev = resolve_device(device)
    if cfg.compute_dtype == "float32":
        disable_tf32()
    model = make_model(cfg.status, cfg.compute_dtype, cfg.freq_s2d)
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_weights(model, params)
    model.to(dev)
    return TrainState(model, make_optimizer(model, cfg.status, cfg.pre, cfg.lr))


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class Bucket:
    """Device-resident padded songs of one bucket length."""

    vqt: torch.Tensor  # (N, S, 96, T)
    pulse: torch.Tensor  # (N, T)
    mask: torch.Tensor  # (N, T)
    names: List[str]
    n_frames: List[int]
    beat_times: List[np.ndarray]


class StagedDataset:
    """Bucketed song records staged on the device once, indexed by song name.

    ``target="downbeat"`` supervises on the downbeat pulse instead (the
    reference builds both pulses, ballroom.py:198-221; beat is its default).
    """

    def __init__(self, records: Sequence[SongRecord], bucket_frames: int, target: str = "beat",
                 *, device: str | torch.device = "cuda"):
        if target not in ("beat", "downbeat"):
            raise ValueError("target must be 'beat' or 'downbeat'")
        dev = resolve_device(device)
        self.bucket_frames = bucket_frames
        self.target = target
        groups: Dict[int, List[SongRecord]] = {}
        for r in records:
            groups.setdefault(_round_up(r.n_frames, bucket_frames), []).append(r)
        self.buckets: Dict[int, Bucket] = {}
        self.location: Dict[str, Tuple[int, int]] = {}  # name -> (bucket_t, row)
        for t, recs in sorted(groups.items()):
            s = recs[0].vqt.shape[0]
            vqt = np.full((len(recs), s, 96, t), PAD_VALUE, dtype=np.float32)
            pulse = np.zeros((len(recs), t), dtype=np.float32)
            mask = np.zeros((len(recs), t), dtype=np.float32)
            for i, r in enumerate(recs):
                vqt[i, :, :, : r.n_frames] = r.vqt
                pulse[i, : r.n_frames] = r.pulse if target == "beat" else r.down_pulse
                mask[i, : r.n_frames] = 1.0
                self.location[r.name] = (t, i)
            times = [
                np.asarray(r.beat_times if target == "beat" else r.downbeat_times) for r in recs
            ]
            self.buckets[t] = Bucket(
                vqt=torch.tensor(vqt, device=dev),
                pulse=torch.tensor(pulse, device=dev),
                mask=torch.tensor(mask, device=dev),
                names=[r.name for r in recs],
                n_frames=[r.n_frames for r in recs],
                beat_times=times,
            )

    def plan(
        self,
        names: Sequence[str],
        batch_size: int,
        shuffle_rng: Optional[np.random.Generator] = None,
    ) -> List[Tuple[int, np.ndarray]]:
        """Batch plan over a subset of songs: list of (bucket_t, row indices)."""
        order = list(names)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        per_bucket: Dict[int, List[int]] = {}
        for n in order:
            t, row = self.location[n]
            per_bucket.setdefault(t, []).append(row)
        plan = []
        for t, rows in sorted(per_bucket.items()):
            for i in range(0, len(rows), batch_size):
                plan.append((t, np.asarray(rows[i : i + batch_size], dtype=np.int32)))
        return plan


def dropout_generator(seed: int, offset: int, device: str | torch.device) -> torch.Generator:
    """The dropout stream of one train step, on ``device``: seeded from the
    run's ``seed`` and the step's ``offset``, where the JAX engine folds the
    offset into its dropout key. The two are mixed into every bit of the
    64-bit seed, as the CPU generator keeps only its low 32 bits."""
    mixed = (seed * 0x9E3779B97F4A7C15 + offset) % 2**64
    return torch.Generator(device=device).manual_seed(mixed ^ (mixed >> 32))


def _loss_and_out(model, vqt, pulse, mask, generator, status: str, pos_weight):
    """Masked logits-space BCE + probability outputs, the one loss of
    train_step and eval_step. With a ``generator`` the model runs in training
    mode and draws dropout from it; without one dropout is off."""
    model.train(generator is not None)
    if status == "pretrained":
        la, lb = model.logits(vqt[:, 0:1], vqt[:, 1:2], generator)
        loss = masked_bce_twin_logits(la, lb, pulse, mask, reduction="max", pos_weight=pos_weight)
        out = torch.sigmoid(torch.maximum(la, lb))
    else:
        logits = model.logits(vqt[:, 0:1], generator)
        loss = masked_bce_logits(logits, pulse, mask, pos_weight)
        out = torch.sigmoid(logits)
    return loss, out


def train_step(state: TrainState, vqt, pulse, mask, generator: Optional[torch.Generator], status: str,
               pos_weight=1.0):
    """One Adam step on (B, S, 96, T) log-VQTs, in logits space
    (losses/bce.py); returns the state, the loss (a 0-d tensor on the
    device) and the probability outputs before the update, for in-loop beat
    scoring like the reference (epochs.py:83-91). The parameters' ``grad``
    holds this step's gradients afterwards."""
    state.optimizer.zero_grad(set_to_none=True)
    loss, out = _loss_and_out(state.model, vqt, pulse, mask, generator, status, pos_weight)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, loss.detach(), out.detach()


def eval_step(state: TrainState, vqt, pulse, mask, status: str, pos_weight=1.0):
    with torch.no_grad():
        return _loss_and_out(state.model, vqt, pulse, mask, None, status, pos_weight)


def run_epoch(
    state: TrainState,
    staged: StagedDataset,
    plan: List[Tuple[int, np.ndarray]],
    cfg: SupervisedConfig,
    *,
    train: bool,
    epoch: int = 0,
    score: bool = True,
) -> Tuple[TrainState, float, np.ndarray]:
    """One pass over a batch plan. Returns (state, mean loss, metric vec (6,))."""
    losses: List[float] = []
    all_scores: List[Tuple[float, ...]] = []
    for i, (t, rows) in enumerate(plan):
        bucket = staged.buckets[t]
        dev = bucket.vqt.device
        idx = torch.as_tensor(rows, dtype=torch.int64, device=dev)
        vqt = bucket.vqt.index_select(0, idx)
        pulse = bucket.pulse.index_select(0, idx)
        mask = bucket.mask.index_select(0, idx)
        if train:
            gen = dropout_generator(cfg.dropout_seed, epoch * 100003 + i, dev)
            state, loss, out = train_step(state, vqt, pulse, mask, gen, cfg.status, cfg.pos_weight)
        else:
            loss, out = eval_step(state, vqt, pulse, mask, cfg.status, cfg.pos_weight)
        losses.append(float(loss))
        if score:
            out_np = out.cpu().numpy()
            for b, row in enumerate(rows):
                est = decode_beats_fn(out_np[b, : bucket.n_frames[row]], cfg.eval_method, fps=FPS)
                all_scores.append(evaluate_beats(bucket.beat_times[row], est))
    metrics = np.mean(np.asarray(all_scores), axis=0) if all_scores else np.zeros(6)
    return state, float(np.mean(losses)) if losses else 0.0, metrics
