"""Masked binary cross-entropy for beat-pulse supervision.

Port of zeronotesamba_tpu/losses/bce.py. The reference trains downstream
models with torch BCELoss on one full song per step (loader.py:16,
epochs.py:48-79). The bucketed engine instead trains on length-padded
batches with a frame mask, so the loss reduces only over valid frames: mean
semantics per song match the reference's unmasked mean.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _masked_mean(ll: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return ll.mean()
    m = mask.float()
    return (ll * m).sum() / torch.clamp_min(m.sum(), 1.0)


def _softplus(z: torch.Tensor) -> torch.Tensor:
    # max(z, 0) + log1p(exp(-|z|)), the JAX formula. At z == 0 exactly its
    # gradient here is 0.5 = sigmoid(0) (torch: d|z|/dz = 0 there); JAX's is
    # 0 (d|z|/dz = 1). Everywhere else the two agree.
    return torch.maximum(z, torch.zeros_like(z)) + torch.log1p(torch.exp(-z.abs()))


def masked_bce(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor | None = None, eps: float = 1e-7):
    """Probability-space BCE (evaluation/reporting; train on logits instead).

    pred/target: (B, T) with pred in (0, 1); mask: (B, T) of {0,1} or None.
    """
    p = torch.clamp(pred.float(), eps, 1.0 - eps)
    t = target.float()
    ll = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    return _masked_mean(ll, mask)


def masked_bce_logits(
    logits: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    pos_weight: float | torch.Tensor = 1.0,
):
    """Numerically stable logits-space BCE: bounded loss AND bounded gradient
    (sigmoid(l) - t).

    ``pos_weight`` (a float or a 0-d tensor) scales the positive-class term
    (torch BCEWithLogitsLoss semantics: loss = -[w*t*log s(l) +
    (1-t)*log(1-s(l))], mean over valid frames). w=1 is exact reference
    parity (loader.py:16 BCELoss).
    """
    l = logits.float()
    t = target.float()
    # -log s(l) = softplus(-l); -log(1-s(l)) = softplus(l), evaluated stably.
    ll = pos_weight * t * _softplus(-l) + (1.0 - t) * _softplus(l)
    return _masked_mean(ll, mask)


def masked_bce_twin_logits(
    anc_logits: torch.Tensor,
    pos_logits: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor | None = None,
    reduction: str = "max",
    pos_weight: float | torch.Tensor = 1.0,
):
    """Stable BCE for the fused downstream model from per-stream logits.

    max fusion: sigmoid(max(la, lb)) == max(sigmoid(la), sigmoid(lb)), so the
    fused BCE is exactly the logits BCE of the elementwise max.
    mean fusion: p = (s(la)+s(lb))/2; log p and log(1-p) evaluate stably via
    log-sigmoid + logaddexp.
    """
    if reduction == "max":
        return masked_bce_logits(torch.maximum(anc_logits, pos_logits), target, mask, pos_weight)
    la, lb = anc_logits.float(), pos_logits.float()
    t = target.float()
    log2 = math.log(2.0)
    logp = torch.logaddexp(F.logsigmoid(la), F.logsigmoid(lb)) - log2
    log1mp = torch.logaddexp(F.logsigmoid(-la), F.logsigmoid(-lb)) - log2
    ll = -(pos_weight * t * logp + (1.0 - t) * log1mp)
    return _masked_mean(ll, mask)
