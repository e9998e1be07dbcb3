"""Downstream supervised beat-tracking engine (device-resident, bucketed).

Port of zeronotesamba_tpu/train/supervised.py. In place of the reference's
per-song B=1 loop (epochs.py:8-187):

- songs are padded into length buckets and staged on the device once as
  (N, S, 96, T) tensors; every epoch then batches by index gathers on the
  device, so shuffling moves a few bytes instead of spectrograms;
- one train step per batch: masked logits-space BCE (losses/bce.py) and an
  Adam update (train/state.py); with ``steps_per_call`` = K, each run of K
  full batches of one bucket is one call (``make_multistep_train_step``),
  one CUDA graph replay on a card (train/multistep.py);
- beat decoding + metric scoring (the reference runs madmom's DBN inside the
  train loop, epochs.py:83-91) happen on the host from the batched outputs.

Dropout: each train step draws its masks from a generator on the device,
seeded from ``dropout_seed`` and the JAX engine's per-step offset
``epoch * 100003 + i`` (``dropout_generator``), so a seeded run repeats its
masks exactly. A step without a generator runs with dropout off, as the JAX
step does with ``dropout_rng=None``.

``train_step`` and ``eval_step`` take an optional ``mesh``
(parallel/mesh.py), the port's form of the JAX dry run's dp x sp x tp
placement: each rank passes its rows and frames of the batch
(``spectrogram_sharding``), the model's convs exchange halo frames over the
time axis and, with a model axis, hold their ``shard_params_tp`` share of
the channels. The masked BCE sums its numerator and denominator over the
data x time ranks, and the gradients are summed over the same ranks (the
gradient group: the ranks that share a model coordinate). Each rank draws
its dropout masks from its own stream (``rank_generator`` at its flat
rank), so the masks match the single-device step's only in distribution.
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
from zeronotesamba_torch.models.baseline import BockTCN
from zeronotesamba_torch.models.encoder import DSCNN, FusedDownstream
from zeronotesamba_torch.models.weights import load_weights
from zeronotesamba_torch.parallel.mesh import Mesh, all_reduce_grads, rank_generator
from zeronotesamba_torch.train.multistep import run_steps
from zeronotesamba_torch.train.state import TrainState, make_optimizer
from zeronotesamba_torch.utils import profiling

FPS = 62.5
PAD_VALUE = float(np.log(1e-9))  # the log-VQT silence floor
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class SupervisedConfig:
    """The JAX engine's fields. ``steps_per_call`` = K > 1 trains each run of
    K full batches of one bucket in one call (``make_multistep_train_step``:
    one CUDA graph on a card, the plain K-step loop on the CPU), with the
    per-step path's numerics. Accepted with no effect: ``rng_impl`` picks the
    TPU's random-bit generator, ``scan_unroll`` the XLA lowering of the K-step
    scan, and ``freq_s2d`` a TPU matrix-unit schedule whose outputs equal the
    plain conv's."""

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
        # Böck-style TCN comparison baseline (replaces the reference's madmom
        # RNNBeatProcessor mode, measures.py:270-277).
        return BockTCN(compute_dtype=dt)
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


def _loss_and_out(model, vqt, pulse, mask, generator, status: str, pos_weight, mesh: Optional[Mesh] = None):
    """Masked logits-space BCE + probability outputs, the one loss of
    train_step and eval_step. With a ``generator`` the model runs in training
    mode and draws dropout from it; without one dropout is off."""
    model.train(generator is not None)
    group = None if mesh is None else mesh.groups["grad"]
    if status == "pretrained":
        la, lb = model.logits(vqt[:, 0:1], vqt[:, 1:2], generator, mesh)
        loss = masked_bce_twin_logits(la, lb, pulse, mask, reduction="max", pos_weight=pos_weight, group=group)
        out = torch.sigmoid(torch.maximum(la, lb))
    else:
        logits = model.logits(vqt[:, 0:1], generator, mesh)
        loss = masked_bce_logits(logits, pulse, mask, pos_weight, group)
        out = torch.sigmoid(logits)
    return loss, out


def train_step(state: TrainState, vqt, pulse, mask, generator: Optional[torch.Generator], status: str,
               pos_weight=1.0, mesh: Optional[Mesh] = None):
    """One Adam step on (B, S, 96, T) log-VQTs, in logits space
    (losses/bce.py); returns the state, the loss (a 0-d tensor on the
    device) and the probability outputs before the update, for in-loop beat
    scoring like the reference (epochs.py:83-91). The parameters' ``grad``
    holds this step's gradients afterwards.

    With a ``mesh`` the arrays are this rank's shards (module docstring):
    the loss is the global batch's, the outputs are this rank's frames, and
    the gradients (this rank's share of each sharded parameter) are the
    global batch's."""
    state.optimizer.zero_grad(set_to_none=True)
    gen = generator if mesh is None else rank_generator(generator, mesh.flat_rank)
    loss, out = _loss_and_out(state.model, vqt, pulse, mask, gen, status, pos_weight, mesh)
    loss.backward()
    if mesh is not None:
        all_reduce_grads(list(state.model.parameters()), mesh.groups["grad"])
    state.optimizer.step()
    state.step += 1
    return state, loss.detach(), out.detach()


def make_multistep_train_step(status: str):
    """K supervised optimizer steps in one call, the counterpart of the JAX
    engine's ``make_multistep_train_step`` (a scan of K steps):
    ``step(state, bucket_vqt, bucket_pulse, bucket_mask, idx, generators,
    pos_weight=1.0)`` -> (state, losses (K,), outs (K, B, T)). Step k trains
    on rows ``idx[k]`` (idx (K, B), on the host or the device) of the staged
    bucket arrays with dropout from ``generators[k]`` (all None: off), so the
    call is K ``train_step`` calls on those rows with those generators. On a
    card the K steps are one CUDA graph, captured at the first call on a
    state and replayed after (train/multistep.py); on the CPU they run one
    after another."""

    def step(state: TrainState, bucket_vqt, bucket_pulse, bucket_mask, idx, generators, pos_weight=1.0):
        idx = torch.as_tensor(idx, dtype=torch.int64)

        def one(k: int, inputs, generator):
            rows = inputs[0][k]
            _, loss, out = train_step(state, bucket_vqt.index_select(0, rows), bucket_pulse.index_select(0, rows),
                                      bucket_mask.index_select(0, rows), generator, status, pos_weight)
            return loss, out

        key = ("supervised", status, float(pos_weight), id(bucket_vqt), id(bucket_pulse), id(bucket_mask),
               tuple(idx.shape))
        losses, outs = run_steps(state, key, one, (idx,), generators, bucket_vqt.device,
                                 keep=(bucket_vqt, bucket_pulse, bucket_mask))
        return state, losses, outs

    return step


def eval_step(state: TrainState, vqt, pulse, mask, status: str, pos_weight=1.0, mesh: Optional[Mesh] = None):
    with torch.no_grad():
        return _loss_and_out(state.model, vqt, pulse, mask, None, status, pos_weight, mesh)


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
    """One pass over a batch plan. Returns (state, mean loss, metric vec (6,)).

    With ``cfg.steps_per_call`` = K > 1 a train pass groups exactly K
    consecutive full-size batches of one bucket into one K-step call and
    reads their losses and outputs once; ragged tails and bucket boundaries
    take the single step, as in the JAX engine. Step k of a group at plan
    index i draws dropout from offset ``epoch * 100003 + i + k``, the single
    step's stream, so both paths compute the same steps."""
    losses: List[float] = []
    all_scores: List[Tuple[float, ...]] = []
    k_call = max(1, int(cfg.steps_per_call)) if train else 1

    def score_batch(out_np: np.ndarray, rows: np.ndarray, bucket: Bucket) -> None:
        for b, row in enumerate(rows):
            est = decode_beats_fn(out_np[b, : bucket.n_frames[row]], cfg.eval_method, fps=FPS, device=bucket.vqt.device)
            with profiling.span("score"):
                all_scores.append(evaluate_beats(bucket.beat_times[row], est))

    i = 0
    while i < len(plan):
        t, rows = plan[i]
        bucket = staged.buckets[t]
        dev = bucket.vqt.device
        if k_call > 1:
            group = []
            while (i + len(group) < len(plan) and len(group) < k_call and plan[i + len(group)][0] == t
                   and len(plan[i + len(group)][1]) == cfg.batch_size):
                group.append(plan[i + len(group)][1])
            if len(group) == k_call:
                gens = [dropout_generator(cfg.dropout_seed, epoch * 100003 + i + k, dev) for k in range(k_call)]
                with profiling.span("epoch.step", request=True):
                    state, losses_k, outs = make_multistep_train_step(cfg.status)(
                        state, bucket.vqt, bucket.pulse, bucket.mask, np.stack(group), gens, cfg.pos_weight)
                    losses.extend(profiling.to_host(losses_k).tolist())
                if score:
                    with profiling.span("epoch.download"):
                        outs_np = profiling.to_host(outs)
                    for k, rws in enumerate(group):
                        score_batch(outs_np[k], rws, bucket)
                i += k_call
                continue
        with profiling.span("epoch.batch", request=True):
            idx = profiling.to_device(rows, dev, torch.int64)
            vqt = bucket.vqt.index_select(0, idx)
            pulse = bucket.pulse.index_select(0, idx)
            mask = bucket.mask.index_select(0, idx)
        with profiling.span("epoch.step"):
            if train:
                gen = dropout_generator(cfg.dropout_seed, epoch * 100003 + i, dev)
                state, loss, out = train_step(state, vqt, pulse, mask, gen, cfg.status, cfg.pos_weight)
            else:
                loss, out = eval_step(state, vqt, pulse, mask, cfg.status, cfg.pos_weight)
            losses.append(float(profiling.to_host(loss)))
        if score:
            with profiling.span("epoch.download"):
                out_np = profiling.to_host(out)
            score_batch(out_np, rows, bucket)
        i += 1
    metrics = np.mean(np.asarray(all_scores), axis=0) if all_scores else np.zeros(6)
    return state, float(np.mean(losses)) if losses else 0.0, metrics
