"""Vectorized NT-Xent contrastive loss (port of zeronotesamba_tpu/losses/ntxent.py).

Semantics of the reference's NTXent (zeroNoteSamba/models/loss_functions.py:7-55):

- similarity  = cosine(anchor_i, positive_j) / temperature
- loss_i      = -log( exp(s_ii) / sum_j exp(s_ij) )   (denominator includes j=i;
                negatives are the other *positives* only; not symmetrized)
- returns (mean loss, mean positive cosine, mean negative cosine)

The cross-device ``ntxent_global`` waits for the torch.distributed slice
(ROADMAP "Modules to port", item 10).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    # torch.nn.CosineSimilarity(eps=1e-8) clamps the norm, not the value.
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(norm, eps)


def ntxent(
    anchors: torch.Tensor, positives: torch.Tensor, temperature: float = 0.25
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, D) x (B, D) -> (mean loss, mean pos cosine, mean neg cosine)."""
    a = _normalize(anchors.float())
    p = _normalize(positives.float())
    sim = a @ p.T  # (B, B) cosine similarities
    logits = sim / temperature
    losses = -(torch.diagonal(logits) - torch.logsumexp(logits, dim=1))
    b = sim.shape[0]
    pos_cos = torch.diagonal(sim).mean()
    neg_cos = (sim.sum() - torch.diagonal(sim).sum()) / (b * (b - 1))
    return losses.mean(), pos_cos, neg_cos
