"""Tensor parallelism over the mesh's ``model`` axis: channel-sharded convs.

After ``parallel/mesh.shard_params_tp`` each model rank holds cout/m output
channels of every conv. The encoder (models/encoder.py) runs each conv on
the whole input with its own weight rows, pools, applies ReLU and dropout
to its channels (all per channel), and gathers the channels of the model
ranks (``gather_channels``) to feed the next conv or, after the last, the
replicated head. The JAX package leaves this partitioning to GSPMD.

Gradients, as Megatron-LM's column-parallel layers take them:

- every model rank computes the same, replicated loss, so the gradient that
  reaches a gathered tensor is already the whole one on each rank; the
  gather's backward takes this rank's channels of it and sums nothing (a
  sum would hand Adam m times the gradient);
- each rank's conv reads the whole input with only its own output
  channels, so the input's gradient on each rank is a partial sum:
  ``replicated_input`` sums it over the model ranks in its backward.

The counter ``tensor.channel_bytes`` (``utils/profiling.count``) adds up the
bytes both collectives deliver to this rank from the others, forward and
backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from zeronotesamba_torch.utils import profiling

profiling.count("tensor.channel_bytes", 0)


class _ReplicatedInput(torch.autograd.Function):
    """Identity; backward: the gradient summed over the model ranks."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.mesh.groups["model"])
        profiling.count("tensor.channel_bytes", (ctx.mesh.shape["model"] - 1) * grad.numel() * grad.element_size())
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """(B, c, ...) on each model rank -> (B, m*c, ...), in rank order.
    Backward: this rank's c channels of the gradient, not summed."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.c = mesh, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(mesh.shape["model"])]
        dist.all_gather(parts, x.contiguous(), group=mesh.groups["model"])
        profiling.count("tensor.channel_bytes", (len(parts) - 1) * x.numel() * x.element_size())
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        k, c = ctx.mesh.coords["model"], ctx.c
        return grad[:, k * c: (k + 1) * c], None


def replicated_input(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as the input of a channel-sharded conv (the identity on a mesh
    whose model axis has one rank)."""
    return x if mesh.shape["model"] == 1 else _ReplicatedInput.apply(x, mesh)


def gather_channels(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every model rank's channels of ``x`` (dim 1), in rank order (the
    identity on a mesh whose model axis has one rank)."""
    return x if mesh.shape["model"] == 1 else _GatherChannels.apply(x, mesh)
