"""Vectorized NT-Xent contrastive loss (port of zeronotesamba_tpu/losses/ntxent.py).

Semantics of the reference's NTXent (zeroNoteSamba/models/loss_functions.py:7-55):

- similarity  = cosine(anchor_i, positive_j) / temperature
- loss_i      = -log( exp(s_ii) / sum_j exp(s_ij) )   (denominator includes j=i;
                negatives are the other *positives* only; not symmetrized)
- returns (mean loss, mean positive cosine, mean negative cosine)

``ntxent_global`` extends the negative set over a data-parallel process
group (parallel/mesh.py): each rank holds (b, D) anchors and positives, the
positives are all-gathered so every anchor sees all B = d*b of them, and
the loss is the mean over the global anchors, as the JAX function computes
it inside shard_map.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from zeronotesamba_torch.parallel.mesh import psum


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


class _AllGatherRows(torch.autograd.Function):
    """(b, D) on each rank -> (d*b, D), rank order. Backward: the gathered
    gradient summed over the ranks (every rank's loss reads every rank's
    rows), then this rank's rows. Written out rather than taken from
    torch.distributed.nn, whose backward goes through all_to_all on every
    backend but NCCL: this one runs the same collectives on gloo and NCCL."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        b = grad.shape[0] // dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return grad[rank * b: (rank + 1) * b], None


def ntxent_global(
    anchors: torch.Tensor, positives: torch.Tensor, temperature: float = 0.25,
    group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NT-Xent over the global batch of a process group (JAX ``ntxent_global``
    under shard_map): this rank's (b, D) anchors against the (d*b, D)
    gathered positives, this rank's positive at column ``rank*b + row``.
    Returns (mean loss over the d*b global anchors, mean positive cosine,
    mean negative cosine), equal on every rank. The loss is differentiable:
    this rank's anchors and positives receive their rows of the global
    batch's gradient, so the parameter gradients of one step are the sum of
    the ranks' (parallel/mesh.all_reduce_grads)."""
    a = _normalize(anchors.float())
    p_all = _AllGatherRows.apply(_normalize(positives.float()), group)  # (B_global, D)
    world = dist.get_world_size(group)
    b_local = a.shape[0]
    b_global = b_local * world
    offset = dist.get_rank(group) * b_local
    sim = a @ p_all.T  # (b_local, B_global)
    pos = sim[torch.arange(b_local, device=sim.device), offset + torch.arange(b_local, device=sim.device)]
    losses = torch.logsumexp(sim / temperature, dim=-1) - pos / temperature
    pos_sum = pos.sum()
    neg_sum = (sim.sum() - pos_sum) / (b_global - 1)
    total = psum(torch.stack([losses.mean(), pos_sum, neg_sum]), group)
    return total[0] / world, total[1] / b_global, total[2] / b_global
