"""Self-supervised contrastive pretraining engine (NT-Xent) on one device.

Port of zeronotesamba_tpu/train/pretext.py. Batch semantics are the
reference's: one batch is ``batch_size`` random ``crop_frames`` shifts of the
SAME track (pretext.py:307-318), so the negatives are other time offsets of
the same audio. The embedding NT-Xent sees is each DSCNN's sigmoid pulse,
(B, crop_frames), as in the JAX ``TwinPretext.__call__``.

``make_staged_train_step`` is the engine's hot path: the (N, 2, 96, T) bank
lives on the device and each step receives only ``(track_idx, starts)``;
the crops come from one index gather on the device.

With a ``mesh`` (parallel/mesh.py) both train steps are data parallel over
its ranks, one process each, as the JAX engine's are over the mesh's
``data`` axis. The host-batch step splits one track's B shifts over the
ranks and takes ``ntxent_global`` (global negatives). The staged step is
track-parallel: each rank holds its own shard of the bank and runs the
local per-track NT-Xent on its k of the update's d*k tracks. Either way
each rank differentiates its share of the global loss, and one flattened
all-reduce sums the parameter gradients before Adam, so every rank holds
the same parameters after every step.

Dropout: a train step draws its masks from the ``torch.Generator`` it is
given (train/supervised.dropout_generator builds one per step), and a step
without a generator runs with dropout off, as in train/supervised.py.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from zeronotesamba_torch.device import disable_tf32, resolve_device
from zeronotesamba_torch.losses.ntxent import ntxent, ntxent_global
from zeronotesamba_torch.models.encoder import DSCNN, TwinPretext
from zeronotesamba_torch.models.weights import load_weights
from zeronotesamba_torch.parallel.mesh import Mesh, all_reduce_grads, pmean, rank_generator, shard_batch
from zeronotesamba_torch.train.state import TrainState, pretext_optimizer


@dataclasses.dataclass
class PretextConfig:
    """The JAX engine's fields. ``freq_s2d`` (a TPU matrix-unit schedule for
    some convs, whose outputs equal the plain conv's) is accepted and has no
    effect here."""

    task: str = "zerons"  # zerons (twin encoders) | clmr (single encoder)
    batch_size: int = 16
    crop_frames: int = 313
    temperature: float = 0.25
    dropout_seed: int = 0
    dropout_rate: float = 0.1
    lr: float = None  # None = reference rules (train/state.pretext_learning_rate)
    compute_dtype: str = "float32"  # float32 | bfloat16: the convs' dtype;
    # params, optimizer state, embeddings and the NT-Xent stay float32
    freq_s2d: Tuple[int, ...] = ()


def resolve_dtype(name) -> torch.dtype:
    """'float32'/'bfloat16' (or an actual dtype) -> torch dtype."""
    if not isinstance(name, str):
        return name
    try:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16, "f32": torch.float32,
                "bf16": torch.bfloat16}[name]
    except KeyError:
        raise ValueError(f"unknown compute_dtype {name!r} (float32|bfloat16)") from None


def make_pretext_model(task: str, dropout_rate: float = 0.1, compute_dtype="float32",
                       freq_s2d: Tuple[int, ...] = ()) -> torch.nn.Module:
    del freq_s2d  # no effect (PretextConfig)
    cls = TwinPretext if task == "zerons" else DSCNN
    return cls(dropout_rate, resolve_dtype(compute_dtype))


def init_pretext_state(cfg: PretextConfig, seed: int, *, params=None,
                       device: str | torch.device = "cuda") -> TrainState:
    """A fresh pretext model and its Adam on ``device``: He-normal weights
    drawn on the CPU from ``seed`` (the same weights on every device), or a
    copy of ``params`` (a state dict or Flax tree, models/weights.load_weights)."""
    dev = resolve_device(device)
    if resolve_dtype(cfg.compute_dtype) == torch.float32:
        disable_tf32()
    model = make_pretext_model(cfg.task, cfg.dropout_rate, cfg.compute_dtype, cfg.freq_s2d)
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_weights(model, params)
    model.to(dev)
    return TrainState(model, pretext_optimizer(model, cfg.task, cfg.lr))


def sample_shifts(bank_frames: int, batch_size: int, crop_frames: int, rng: np.random.Generator) -> np.ndarray:
    """Random shift starts (reference samples from range(0, 313) on 626-frame
    items WITHOUT replacement via random.sample, pretext.py:307-318).

    Sampling without replacement whenever the population allows keeps an
    anchor's exact positive out of its own negative set; replacement is the
    fallback only when there are fewer possible starts than batch slots.
    """
    max_start = bank_frames - crop_frames
    return rng.choice(max_start + 1, size=batch_size, replace=max_start + 1 < batch_size).astype(np.int32)


def crop_shifts(
    bank_item: np.ndarray, batch_size: int, crop_frames: int, rng: np.random.Generator
) -> np.ndarray:
    """(2, 96, T) -> (batch_size, 2, 96, crop_frames) random shifts.

    The reference samples starts from range(0, 313) on a 626-frame bank item
    (pretext.py:307-318); generalized to range(0, T - crop_frames + 1).
    """
    t = bank_item.shape[-1]
    starts = sample_shifts(t, batch_size, crop_frames, rng)
    return np.stack([bank_item[:, :, s : s + crop_frames] for s in starts])


def batches_from_bank(
    bank: np.ndarray, cfg: PretextConfig, rng: np.random.Generator, shuffle: bool = True
) -> Iterator[np.ndarray]:
    """Yield (B, 2, 96, crop) batches, one per track, reference semantics."""
    order = rng.permutation(len(bank)) if shuffle else np.arange(len(bank))
    for i in order:
        yield crop_shifts(bank[i], cfg.batch_size, cfg.crop_frames, rng)


def _forward(model, anchors: torch.Tensor, positives: torch.Tensor, task: str,
             generator: Optional[torch.Generator]):
    """(anchor, positive) embeddings: the two pulses, (B, T) each. With a
    ``generator`` the model runs in training mode and draws dropout from it."""
    model.train(generator is not None)
    if task == "zerons":
        return model(anchors, positives, generator)
    return model(anchors, generator), model(positives, generator)


def _batch_loss(model, batch: torch.Tensor, cfg: PretextConfig, generator: Optional[torch.Generator], k: int = 1):
    """NT-Xent of (k*B, 2, 96, crop) crops as k per-track blocks of B: the
    mean of the k tracks' loss and cosines, each track's negatives only its
    own shifts."""
    a_emb, p_emb = _forward(model, batch[:, 0:1], batch[:, 1:2], cfg.task, generator)
    losses, pcs, ncs = ntxent(a_emb.view(k, -1, a_emb.shape[-1]), p_emb.view(k, -1, p_emb.shape[-1]),
                              cfg.temperature)
    return losses.mean(), pcs.mean(), ncs.mean()


def _update(state: TrainState, loss_fn, mesh: Optional[Mesh] = None):
    state.optimizer.zero_grad(set_to_none=True)
    loss, pc, nc = loss_fn(state.model)
    loss.backward()
    if mesh is not None:
        all_reduce_grads(list(state.model.parameters()), mesh)
    state.optimizer.step()
    state.step += 1
    return state, loss.detach(), pc.detach(), nc.detach()


def make_train_step(cfg: PretextConfig, mesh: Optional[Mesh] = None):
    """The host-batch train step: ``step(state, batch, generator)`` on a
    (B, 2, 96, crop) batch -> (state, loss, pos cosine, neg cosine), each a
    0-d tensor on the device. The parameters' ``grad`` holds this step's
    gradients afterwards.

    With a ``mesh`` every rank passes the same global batch and takes its
    B/d rows (B must divide by d); the loss is ``ntxent_global`` over the
    global batch, so the step equals the single-device step on that batch
    (at dropout 0: each rank draws its own masks, ``rank_generator``)."""
    if mesh is None:
        def step(state: TrainState, batch: torch.Tensor, generator: Optional[torch.Generator]):
            return _update(state, lambda m: _batch_loss(m, batch, cfg, generator))

        return step

    def sharded_loss(model, batch, generator):
        a_emb, p_emb = _forward(model, batch[:, 0:1], batch[:, 1:2], cfg.task, generator)
        return ntxent_global(a_emb, p_emb, cfg.temperature, mesh.group)

    def step(state: TrainState, batch, generator: Optional[torch.Generator]):
        local = shard_batch(mesh, batch)
        gen = rank_generator(generator, mesh.rank)
        return _update(state, lambda m: sharded_loss(m, local, gen), mesh)

    return step


def make_eval_step(cfg: PretextConfig):
    """``step(state, batch)`` -> (loss, pos cosine, neg cosine), dropout off."""

    def step(state: TrainState, batch: torch.Tensor):
        with torch.no_grad():
            return _batch_loss(state.model, batch, cfg, None)

    return step


def staged_crops(bank: torch.Tensor, track_idx: torch.Tensor, starts: torch.Tensor, crop_frames: int) -> torch.Tensor:
    """(k, B, 2, 96, crop) crops of a device-resident (N, 2, 96, T) bank:
    row ``track_idx[i]``, frames ``starts[i, b] + arange(crop)``, in one index
    gather. ``track_idx`` is (k,) and ``starts`` (k, B); out-of-range values
    are clamped into the bank, as the JAX engine's dynamic slices clamp them."""
    n, c, f, t = bank.shape
    k, b = starts.shape
    dev = bank.device
    ti = track_idx.clamp(0, n - 1).view(k, 1, 1, 1, 1)
    frames = starts.clamp(0, t - crop_frames).view(k, b, 1, 1, 1) + torch.arange(crop_frames, device=dev)
    return bank[ti, torch.arange(c, device=dev).view(c, 1, 1), torch.arange(f, device=dev).view(f, 1), frames]


def make_staged_train_step(cfg: PretextConfig, mesh: Optional[Mesh] = None, steps_per_call: int = 1,
                           scan_unroll=False):
    """Train step over a DEVICE-RESIDENT bank: ``step(state, bank, track_idx,
    starts, generator)`` -> (state, loss, pos cosine, neg cosine).

    The (N, 2, 96, T) bank stays on the device and each step receives only
    (track_idx, starts): the reference's host-side shift cropping
    (pretext.py:307-318) becomes one gather on the device (``staged_crops``).
    ``track_idx`` is a scalar with (B,) starts (one track, the reference
    cadence) or a (k,) vector with (k, B) starts: k per-track NT-Xent batches
    as ONE flattened (k*B) encoder batch, with the mean loss of the k tracks
    (gradient accumulation across tracks; each track's negatives are only
    its own shifts). k = 1 is the plain step.

    ``steps_per_call`` and ``scan_unroll`` are accepted and have no effect:
    the JAX engine scans S optimizer steps in one dispatched program to hide a
    fixed per-call relay cost; here every update is one step call. The JAX
    driver then pads each epoch's updates to a multiple of S by drawing extra
    tracks (experiments/pretext_driver.py:303-306), so at S > 1 its shuffle
    stream differs from the port's, which runs the S = 1 schedule.

    With a ``mesh`` the step is track-parallel, as the JAX mesh step: each
    rank passes its own (N/d, 2, 96, T) shard of the bank, and every rank
    the same (d*k,) ``track_idx`` of LOCAL indices and (d*k, B) ``starts``;
    rank i takes rows [i*k, (i+1)*k), runs the k-track loss on its shard,
    and the loss, the cosines and the gradients are averaged over the
    ranks. The step over d*k tracks equals the single-device k' = d*k step
    over the same tracks (at dropout 0: each rank draws its own masks,
    ``rank_generator``).
    """
    del steps_per_call, scan_unroll

    def loss_fn(model, bank, track_idx, starts, generator):
        ti = torch.as_tensor(track_idx, dtype=torch.int64, device=bank.device).reshape(-1)
        st = torch.as_tensor(starts, dtype=torch.int64, device=bank.device).reshape(ti.shape[0], -1)
        if mesh is not None:
            if ti.shape[0] % mesh.size:
                raise ValueError(f"{ti.shape[0]} track indices do not split over the {mesh.size} ranks")
            k = ti.shape[0] // mesh.size
            ti, st = ti[mesh.rank * k: (mesh.rank + 1) * k], st[mesh.rank * k: (mesh.rank + 1) * k]
        crops = staged_crops(bank, ti, st, cfg.crop_frames)
        loss, pc, nc = _batch_loss(model, crops.flatten(0, 1), cfg, generator, k=ti.shape[0])
        if mesh is None:
            return loss, pc, nc
        return tuple(pmean(torch.stack([loss, pc.detach(), nc.detach()]), mesh.group))

    def step(state: TrainState, bank: torch.Tensor, track_idx, starts, generator: Optional[torch.Generator]):
        gen = generator if mesh is None else rank_generator(generator, mesh.rank)
        return _update(state, lambda m: loss_fn(m, bank, track_idx, starts, gen), mesh)

    return step
