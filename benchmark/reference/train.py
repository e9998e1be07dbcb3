"""Supervised fine-tuning, plainly: masked BCE on logits and Adam.

A batch is (B, S, 96, T) log-VQTs padded to the bucket length with the
silence floor log(1e-9), the beat pulse targets (1 at each annotated beat's
frame, 0.5 beside it, the frame clamped into [1, T - 2]) and a mask of the
song's frames. The loss is the mean over masked frames of
``t softplus(-l) + (1 - t) softplus(l)``; Adam has betas (0.9, 0.999) and
eps 1e-8. Each step's dropout masks come from a generator on the device
seeded from the run's seed and the step's offset as the configuration
states it (``dropout_generator``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import models

BETAS, EPS = (0.9, 0.999), 1e-8


def beat_pulse(beat_times: Sequence[float], n_frames: int, fps: float) -> np.ndarray:
    pulse = np.zeros(n_frames, dtype=np.float32)
    for t in beat_times:
        i = min(max(int(round(fps * float(t))), 1), n_frames - 2)
        pulse[i] = 1.0
        pulse[i - 1] = max(pulse[i - 1], 0.5)
        pulse[i + 1] = max(pulse[i + 1], 0.5)
    return pulse


def dropout_generator(seed: int, offset: int, device) -> torch.Generator:
    """The stream one train step draws its dropout masks from: ``seed`` and
    the step's ``offset`` mixed into one 64-bit seed."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + offset) % 2**64
    return torch.Generator(device=device).manual_seed(mixed ^ (mixed >> 32))


def batch(vqts: List[torch.Tensor], beats: List[np.ndarray], bucket: int, pad: float, fps: float):
    """Songs' (S, 96, n) log-VQTs and beat times -> (x, pulse, mask) padded to ``bucket`` frames."""
    dev = vqts[0].device
    x = torch.full((len(vqts), vqts[0].shape[0], vqts[0].shape[1], bucket), pad, device=dev)
    pulse = torch.zeros(len(vqts), bucket, device=dev)
    mask = torch.zeros(len(vqts), bucket, device=dev)
    for i, (v, b) in enumerate(zip(vqts, beats)):
        n = v.shape[-1]
        x[i, :, :, :n] = v.float()
        pulse[i, :n] = torch.as_tensor(beat_pulse(b, n, fps), device=dev)
        mask[i, :n] = 1.0
    return x, pulse, mask


def masked_bce(logits: torch.Tensor, pulse: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    ll = pulse * F.softplus(-logits) + (1.0 - pulse) * F.softplus(logits)
    return (ll * mask).sum() / mask.sum().clamp_min(1.0)


def train_steps(weights: Dict[str, torch.Tensor], cfg: dict, batches, generators, lr: float,
                moments=None, steps_done: int = 0) -> dict:
    """Adam steps from ``weights`` on ``batches`` with dropout from
    ``generators``: each step's loss, the first step's gradients, and the
    parameters after the last step. Adam starts from zero moments, or from
    ``moments`` (first, second) after ``steps_done`` steps."""
    w = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    if moments is None:
        m = {k: torch.zeros_like(v) for k, v in w.items()}
        v2 = {k: torch.zeros_like(v) for k, v in w.items()}
    else:
        m, v2 = ({k: d[k].detach().clone().to(w[k].device) for k in w} for d in moments)
    losses, first = [], None
    for t, ((x, pulse, mask), gen) in enumerate(zip(batches, generators), start=steps_done + 1):
        loss = masked_bce(models.logits(w, x, cfg, gen), pulse, mask)
        grads = torch.autograd.grad(loss, list(w.values()))
        losses.append(loss.item())
        with torch.no_grad():
            if first is None:
                first = {k: g.detach().clone() for k, g in zip(w, grads)}
            for (k, p), g in zip(w.items(), grads):
                m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                step = lr * (m[k] / (1 - BETAS[0] ** t)) / ((v2[k] / (1 - BETAS[1] ** t)).sqrt() + EPS)
                p.sub_(step)
    return {"losses": losses, "first_grad": first, "params": {k: p.detach() for k, p in w.items()}}


def evaluate(weights: Dict[str, torch.Tensor], cfg: dict, x, pulse, mask):
    """(loss, probabilities) of a batch with dropout off."""
    with torch.no_grad():
        logits = models.logits(weights, x, cfg)
        return float(masked_bce(logits, pulse, mask)), torch.sigmoid(logits)


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> Dict[str, float]:
    """Each leaf's gap between the two norms, over the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    norms = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(norms.values())))
    return {k: abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30) for k in keys}


def leaf_gap(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keys) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, ref, keys).values())


def moved_leaves(first_grad: Dict[str, torch.Tensor], share: float = 1e-3) -> list:
    """Leaves whose first gradient in the reference is not nought to rounding:
    over ``share`` of the median leaf's norm."""
    norms = {k: float(g.double().norm()) for k, g in first_grad.items()}
    med = float(np.median(list(norms.values())))
    return [k for k, n in norms.items() if n > share * med and math.isfinite(n)]
