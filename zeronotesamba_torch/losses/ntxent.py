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
    """(..., B, D) x (..., B, D) -> (mean loss, mean pos cosine, mean neg
    cosine), each of shape (...): one NT-Xent per (B, D) block, whose
    negatives are only that block's other positives."""
    a = _normalize(anchors.float())
    p = _normalize(positives.float())
    sim = a @ p.transpose(-1, -2)  # (..., B, B) cosine similarities
    logits = sim / temperature
    diag = torch.diagonal(sim, dim1=-2, dim2=-1)
    losses = torch.logsumexp(logits, dim=-1) - diag / temperature
    b = sim.shape[-1]
    neg_cos = (sim.sum(dim=(-2, -1)) - diag.sum(dim=-1)) / (b * (b - 1))
    return losses.mean(dim=-1), diag.mean(dim=-1), neg_cos
