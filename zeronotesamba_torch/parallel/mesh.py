"""The device mesh over torch.distributed (port of zeronotesamba_tpu/parallel/mesh.py).

The JAX package runs one controller over a ``jax.sharding.Mesh`` of axes
``data``, ``time`` and ``model``. The port runs one process per rank (SPMD),
joined in a process group (NCCL on the cards, gloo on the CPU;
parallel/launch.py starts them). A ``Mesh`` is this process's view of that
group over the same three axes: the axis sizes, this rank's coordinate on
each, one process group per axis line, and its device. Ranks are laid out
row-major over (data, time, model), as the JAX mesh reshapes its device
list.

- ``data``: batch parallelism. ``Mesh.size``, ``Mesh.rank`` and
  ``Mesh.group`` are this axis's size, this rank's coordinate on it and its
  group, so the data-parallel paths (the pretext steps, ``ntxent_global``,
  ``train_pretext``) read the data axis on any mesh.
- ``time``: sequence parallelism over the convs' time axis. The JAX package
  leaves the halo exchange to GSPMD; here each conv of the encoder takes its
  halo frames from its time neighbours (parallel/sequence.py).
- ``model``: tensor parallelism over the convs' output channels
  (``shard_params_tp``; parallel/tensor.py gathers the channels after each
  conv).

Where the JAX package places an array with a sharding
(``jax.device_put(a, batch_sharding(mesh))``), the port calls the sharding:
``batch_sharding(mesh)(a)`` is this rank's rows of the global array ``a``
on ``mesh.device``, ``spectrogram_sharding(mesh)(a)`` its rows and frames.

Gradients: each rank differentiates its share of the global loss
(``psum`` passes the gradient of the summed value back to every rank's
term unchanged), so the parameter gradients are SUMMED over the ranks that
hold different data (``all_reduce_grads``), in one flattened all-reduce:
the data group for the pretext steps, whose time and model ranks repeat the
data rank's work, and the gradient group (the ranks that share a model
coordinate) for the supervised step, whose time ranks hold different frames.
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

AXES = ("data", "time", "model")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. ``shape`` reads as the JAX mesh's
    (``mesh.shape["data"]``). ``rank`` and ``group`` are the data axis's:
    this rank's coordinate on it and its process group (None, in a mesh
    built by hand: the default group). ``coords`` holds the coordinate on
    every axis and ``groups`` the group of every axis line through this
    rank, plus ``"grad"``, the ranks that share this rank's model
    coordinate. A mesh built by hand whose time and model axes have size 1
    may leave them out: they follow from ``rank`` and ``group``."""

    shape: dict
    rank: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    coords: Optional[dict] = None
    groups: Optional[dict] = None

    def __post_init__(self):
        if self.coords is None or self.groups is None:
            if self.shape["time"] != 1 or self.shape["model"] != 1:
                raise ValueError(f"mesh {self.shape}: a time or model axis needs its coords and groups")
            object.__setattr__(self, "coords", {"data": self.rank, "time": 0, "model": 0})
            object.__setattr__(self, "groups", {"data": self.group, "grad": self.group})

    @property
    def size(self) -> int:
        return self.shape["data"]

    @property
    def flat_rank(self) -> int:
        """This rank's row-major index over (data, time, model)."""
        return (self.coords["data"] * self.shape["time"] + self.coords["time"]) * self.shape["model"] \
            + self.coords["model"]


def _axis_lines(data: int, time: int, model: int) -> dict:
    """Each axis's lines of (parent-group) ranks, one row a line, in order;
    ``grad`` holds the (data, time) plane of each model coordinate."""
    r = np.arange(data * time * model).reshape(data, time, model)
    return {"data": r.transpose(1, 2, 0).reshape(-1, data), "time": r.transpose(0, 2, 1).reshape(-1, time),
            "model": r.reshape(-1, model), "grad": r.transpose(2, 0, 1).reshape(model, -1)}


def make_mesh(data: Optional[int] = None, time: int = 1, model: int = 1, *,
              device: Optional[str | torch.device] = None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh over an initialised process group (parallel/launch.py),
    ``group`` (None: the default group, held as ``dist.group.WORLD``).
    ``data=None`` takes every rank the time and model axes leave. An axis
    line that spans the whole group uses ``group`` itself; every other line
    gets a group of its own (``dist.new_group``, a collective call: every
    rank builds the same meshes in the same order). ``device`` defaults to
    the current CUDA device under NCCL and to the CPU under any other
    backend."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (zeronotesamba_torch.parallel.launch)")
    world = dist.get_world_size(group)
    if data is None:
        data = world // (time * model)
    if data * time * model != world:
        raise ValueError(f"mesh {data}x{time}x{model} != {world} devices")
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(rank, (data, time, model)))))
    groups = {}
    for axis, lines in _axis_lines(data, time, model).items():
        if lines.shape[1] == world:
            groups[axis] = group
            continue
        for line in lines:
            g = dist.new_group([dist.get_global_rank(group, r) for r in line.tolist()])
            if rank in line:
                groups[axis] = g
    if device is None:
        nccl = dist.get_backend(group) == "nccl"
        device = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    return Mesh({"data": data, "time": time, "model": model}, coords["data"], torch.device(device), groups["data"],
                coords, groups)


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


def spectrogram_sharding(mesh: Mesh) -> Callable:
    """(B, ..., T) arrays with time last, as the port lays out its (B, S,
    96, T) log-VQTs and (B, T) pulses and masks: the returned function gives
    this rank's B/d rows and T/t frames of a global array, on
    ``mesh.device`` (JAX ``P("data", None, None, "time")`` and
    ``P("data", "time")``). B must divide by d and T by t."""
    rows = batch_sharding(mesh)

    def place(a):
        t, n = a.shape[-1], mesh.shape["time"]
        if t % n:
            raise ValueError(f"{t} frames do not split over the {n} ranks of the time axis")
        j = mesh.coords["time"]
        return rows(a[..., j * (t // n): (j + 1) * (t // n)]).contiguous()

    return place


def replicated(mesh: Mesh) -> Callable:
    """The whole array on every rank: the returned function puts a global
    array on ``mesh.device``."""
    return lambda a: torch.as_tensor(a, device=mesh.device)


def shard_params_tp(mesh: Mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Tensor-parallel placement of ``model``'s parameters over the model
    axis, in place, before any optimizer step: every parameter whose dim 0
    divides by the axis size keeps this rank's slice of it, the others stay
    whole. Dim 0 is the output channel of a conv weight (cout, cin, ...) and
    of its bias, the last dim of the Flax kernel (kh, kw, cin, cout), so this
    is the JAX rule: the encoder's eight conv kernels and biases are
    sharded, the head's (1, 128, 1) weight and (1,) bias replicated. The
    sharded names go to ``model.tp_sharded`` (``gather_tp`` reads them)."""
    m, k = mesh.shape["model"], mesh.coords["model"]
    sharded = []
    for name, p in model.named_parameters():
        if m > 1 and p.ndim >= 1 and p.shape[0] % m == 0:
            n = p.shape[0] // m
            p.data = p.data[k * n: (k + 1) * n].clone()
            sharded.append(name)
    model.tp_sharded = frozenset(sharded)
    return model


def gather_tp(mesh: Mesh, model: torch.nn.Module, tensors: dict) -> dict:
    """Whole tensors from this rank's share of them, by parameter name (the
    parameters or their gradients): each one that ``shard_params_tp`` sliced
    is all-gathered over the model axis along dim 0; the rest are copied.
    Every rank of a model line must call it."""
    out = {}
    for name, t in tensors.items():
        if name in getattr(model, "tp_sharded", ()):
            parts = [torch.empty_like(t) for _ in range(mesh.shape["model"])]
            dist.all_gather(parts, t.detach().contiguous(), group=mesh.groups["model"])
            out[name] = torch.cat(parts)
        else:
            out[name] = t.detach().clone()
    return out


def gather_params_tp(mesh: Mesh, model: torch.nn.Module) -> dict:
    """The whole state dict of a tensor-parallel model (the inverse of
    ``shard_params_tp``), for a checkpoint or a comparison."""
    return gather_tp(mesh, model, model.state_dict())


def _src(group: Optional[dist.ProcessGroup]) -> int:
    """The global rank of ``group``'s first rank, which a broadcast names as its source."""
    return 0 if group is None else dist.get_global_rank(group, 0)


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


def all_reduce_grads(params: Sequence[torch.nn.Parameter], group: Optional[dist.ProcessGroup]) -> None:
    """Sum every parameter's gradient over the ranks of ``group``, in one
    flattened all-reduce; a parameter without a gradient is left without one."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_scalars(values: Sequence[float], mesh: Mesh) -> list:
    """Data rank 0's float values on every rank of the data axis (float64, one broadcast)."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, _src(mesh.group), group=mesh.group)
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
        dist.broadcast_object_list(path, _src(mesh.group), group=mesh.group)
        out = a if mesh.rank == 0 else np.load(path[0], mmap_mode="r")
        dist.barrier(group=mesh.group,
                     device_ids=[mesh.device.index] if dist.get_backend(mesh.group) == "nccl" else None)
    finally:
        if mesh.rank == 0 and path[0] is not None:
            shutil.rmtree(os.path.dirname(path[0]))
    return out
