"""Sequence parallelism over the mesh's ``time`` axis: the convs' halo exchange.

Each time rank holds T/t frames of every song of its data rank. A conv of
kernel width kw reads kw // 2 frames past each end of its shard, so before
each conv the encoder (models/encoder.py) asks its time neighbours for those
frames (``exchange_halo``) and runs the conv with no time padding. The
first and last time ranks put zeros where SAME padding puts them, so the
shards' outputs are the unsharded conv's output, split. The JAX package
leaves this exchange to GSPMD, which inserts it for the time-sharded convs.

The exchange is one ``all_gather`` in the time group, forward and backward,
of each rank's two edge blocks; each rank keeps its neighbours' and
discards the rest. Point-to-point sends are not used: several gloo ranks
may share one card, and gloo's send and recv of CUDA tensors are not
relied on. The counter ``sequence.halo_bytes`` (``utils/profiling.count``)
adds up the bytes the gathers deliver to this rank from the others, forward
and backward.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from zeronotesamba_torch.utils import profiling

profiling.count("sequence.halo_bytes", 0)


def _gather_edges(edges: torch.Tensor, mesh) -> list:
    parts = [torch.empty_like(edges) for _ in range(mesh.shape["time"])]
    dist.all_gather(parts, edges.contiguous(), group=mesh.groups["time"])
    profiling.count("sequence.halo_bytes", (len(parts) - 1) * edges.numel() * edges.element_size())
    return parts


class _HaloExchange(torch.autograd.Function):
    """(..., T) -> (..., halo + T + halo): the left neighbour's last ``halo``
    frames, this shard, the right neighbour's first ``halo`` frames (zeros
    past either end of the song). Backward: each halo's gradient goes back
    to the neighbour it came from and is added into that neighbour's edge
    frames."""

    @staticmethod
    def forward(ctx, x, halo, mesh):
        ctx.halo, ctx.mesh = halo, mesh
        j, n = mesh.coords["time"], mesh.shape["time"]
        parts = _gather_edges(torch.cat([x[..., :halo], x[..., -halo:]], dim=-1), mesh)
        zeros = x.new_zeros(x.shape[:-1] + (halo,))
        left = parts[j - 1][..., halo:] if j > 0 else zeros
        right = parts[j + 1][..., :halo] if j < n - 1 else zeros
        return torch.cat([left, x, right], dim=-1)

    @staticmethod
    def backward(ctx, grad):
        h, mesh = ctx.halo, ctx.mesh
        j, n = mesh.coords["time"], mesh.shape["time"]
        parts = _gather_edges(torch.cat([grad[..., :h], grad[..., -h:]], dim=-1), mesh)
        g = grad[..., h:-h].clone()
        if j > 0:  # the left neighbour's right halo is this shard's first frames
            g[..., :h] += parts[j - 1][..., h:]
        if j < n - 1:  # the right neighbour's left halo is this shard's last frames
            g[..., -h:] += parts[j + 1][..., :h]
        return g, None, None


def exchange_halo(x: torch.Tensor, halo: int, mesh) -> torch.Tensor:
    """This time shard of ``x`` (..., T) with ``halo`` frames of its
    neighbours on each side, differentiable; zero-padded on a mesh whose
    time axis has one rank. A shard shorter than the halo would need frames
    from beyond its neighbours, so it raises ``ValueError``."""
    if mesh.shape["time"] == 1:
        return F.pad(x, (halo, halo))
    if x.shape[-1] < halo:
        raise ValueError(f"{x.shape[-1]} frames a time rank is fewer than the {halo} a conv needs from each "
                         "neighbour: the encoder's convs need at least 12")
    return _HaloExchange.apply(x, halo, mesh)
