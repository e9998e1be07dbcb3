"""The data-parallel mesh over torch.distributed (port of zeronotesamba_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of axes
``data``, ``time`` and ``model``. The port runs PyTorch's own form of the
same data parallelism: one process per card (SPMD), joined in a process
group (NCCL on the cards, gloo on the CPU; parallel/launch.py starts them).
A ``Mesh`` is this process's view of that group: the axis sizes, its rank
and its device.

Only the ``data`` axis is ported, which is all the JAX package runs under a
mesh (``pretext --data-parallel`` builds ``make_mesh(time=1)``). The
``time`` axis (GSPMD's halo exchange for the time-dim convs) and the
``model`` axis (channel-partitioned convs) have no one-call torch
counterpart; ``make_mesh`` refuses a size above 1 on either. The JAX
module's ``spectrogram_sharding``, ``replicated`` and ``shard_params_tp``
have no caller in either package and are not ported.

Where the JAX package places an array with a sharding
(``jax.device_put(a, batch_sharding(mesh))``), the port calls the sharding:
``batch_sharding(mesh)(a)`` is this rank's rows of the global array ``a``
on ``mesh.device``.

Gradients: each rank differentiates its share of the global loss
(``psum`` passes the gradient of the summed value back to every rank's
term unchanged), so the parameter gradients are SUMMED over ranks
(``all_reduce_grads``), in one flattened all-reduce.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES_NOT_PORTED = (
    "only the data axis is ported: the time axis (GSPMD halo exchange for the convs) and the model axis "
    "(channel-partitioned convs) have no one-call torch counterpart (ROADMAP 'Modules to port', item 10)"
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a data-parallel process group. ``shape`` reads as
    the JAX mesh's (``mesh.shape["data"]``); ``group`` None is the default
    process group."""

    shape: dict
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.shape["data"]


def make_mesh(data: Optional[int] = None, time: int = 1, model: int = 1, *,
              device: Optional[str | torch.device] = None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh over an initialised process group (parallel/launch.py).
    ``data=None`` takes every rank. ``device`` defaults to the current CUDA
    device under NCCL and to the CPU under any other backend."""
    if time != 1 or model != 1:
        raise NotImplementedError(f"mesh {data}x{time}x{model}: {AXES_NOT_PORTED}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (zeronotesamba_torch.parallel.launch)")
    world = dist.get_world_size(group)
    if data is None:
        data = world // (time * model)
    if data * time * model != world:
        raise ValueError(f"mesh {data}x{time}x{model} != {world} devices")
    if device is None:
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh({"data": data, "time": time, "model": model}, dist.get_rank(group), torch.device(device), group)


def batch_sharding(mesh: Mesh) -> Callable:
    """(B, ...) arrays sharded over the data axis: the returned function
    takes a global host array (numpy or tensor) and gives this rank's B/d
    rows on ``mesh.device``. B must divide by d."""

    def place(a):
        n, d = len(a), mesh.size
        if n % d:
            raise ValueError(f"{n} rows do not split over the {d} ranks of the data axis")
        return torch.as_tensor(a[mesh.rank * (n // d): (mesh.rank + 1) * (n // d)], device=mesh.device)

    return place


def shard_batch(mesh: Mesh, *arrays):
    """This rank's rows of each global array, on its device."""
    place = batch_sharding(mesh)
    out = tuple(place(a) for a in arrays)
    return out if len(out) > 1 else out[0]


class _SumOverRanks(torch.autograd.Function):
    """All-reduce SUM whose backward hands the summed value's gradient back
    to this rank's term unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The sum of ``x`` over the ranks (JAX ``lax.psum``), differentiable."""
    return _SumOverRanks.apply(x, group)


def pmean(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """The mean of ``x`` over the ranks (JAX ``lax.pmean``), differentiable:
    each rank's ``x`` gets 1/d of the mean's gradient."""
    return psum(x, group) / dist.get_world_size(group)


def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum every parameter's gradient over the ranks, in one flattened
    all-reduce; a parameter without a gradient is left without one."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_scalars(values: Sequence[float], mesh: Mesh) -> list:
    """Rank 0's float values on every rank (float64, one broadcast)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, 0, group=mesh.group)
    return t.tolist()


def rank_generator(generator: Optional[torch.Generator], rank: int) -> Optional[torch.Generator]:
    """This rank's dropout stream from the step's ``generator``. Rank 0 draws
    from ``generator`` itself, so rank 0 of a mesh draws the single-device
    masks; rank r > 0 from a generator on the same device seeded
    ``m ^ (m >> 32)`` with ``m = (seed + r * 0x9E3779B97F4A7C15) mod 2**64``
    (the CPU generator keeps only the low 32 bits of a seed, so the high
    half is folded in). The JAX mesh folds the axis index into its key, so
    the masks match JAX's only in distribution."""
    if generator is None or rank == 0:
        return generator
    mixed = (generator.initial_seed() + rank * 0x9E3779B97F4A7C15) % 2**64
    return torch.Generator(device=generator.device).manual_seed(mixed ^ (mixed >> 32))


def host_array_from_rank0(a: Optional[np.ndarray], mesh: Mesh) -> np.ndarray:
    """Rank 0's host array ``a`` on every rank, held once on the host: rank 0
    writes it to a .npy in a new temporary directory, and every other rank
    maps that file read-only (``np.load(mmap_mode="r")``), so a rank reads
    only the rows it touches. The file is deleted once every rank has mapped
    it. The ranks share one host; ``a`` on the other ranks is ignored."""
    if mesh.size == 1:
        return a
    path = [None]
    try:
        if mesh.rank == 0:
            path[0] = os.path.join(tempfile.mkdtemp(prefix="zns_host_"), "array.npy")
            np.save(path[0], a)
        dist.broadcast_object_list(path, 0, group=mesh.group)
        out = a if mesh.rank == 0 else np.load(path[0], mmap_mode="r")
        dist.barrier(group=mesh.group,
                     device_ids=[mesh.device.index] if dist.get_backend(mesh.group) == "nccl" else None)
    finally:
        if mesh.rank == 0 and path[0] is not None:
            shutil.rmtree(os.path.dirname(path[0]))
    return out
