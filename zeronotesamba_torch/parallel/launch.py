"""Start and join the ranks of a data-parallel world, one process per card.

The JAX package drives its mesh from one controller process. The port runs
one process per rank (SPMD) in a torch.distributed process group, and
``launch`` starts or joins it:

- under torchrun (``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set), this
  process joins that world, on ``cuda:LOCAL_RANK`` over NCCL (or over gloo
  on the CPU); the ranks must share one host, as the CLI's ranks share its
  bank through a file (cli.py);
- otherwise, on ``cuda``, it spawns one rank per visible card, rank r on
  ``cuda:r`` over NCCL;
- on ``cpu``, one gloo rank runs in this process.

``run_ranks`` spawns a world of any size and backend
(``torch.multiprocessing.start_processes``) and returns each rank's result
(the tests run two gloo ranks on the CPU with it). Spawned ranks meet at a
file store in a new temporary directory, never at a fixed TCP port, so many
worlds can start at once on one host. A rank that raises makes the launcher
stop the other ranks and raise; every process group is destroyed on the way
out. A collective waits at most ``TIMEOUT_S`` for a late rank; a run has no
time limit unless its caller sets one.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Callable, Iterator, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from zeronotesamba_torch.device import resolve_device
from zeronotesamba_torch.parallel.mesh import Mesh, make_mesh

# A collective waits at most this long for a late rank (rank 0 alone runs the
# validation and the proxy F1 while the others wait at a broadcast). It
# bounds one wait, not a run.
TIMEOUT_S = 1800.0
_FAIL_GRACE_S = 10.0  # how long the other ranks may take to end on their own after one fails
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@contextlib.contextmanager
def process_group(backend: str, rank: int, world: int, init_method: str, device: str | torch.device,
                  timeout_s: float = TIMEOUT_S) -> Iterator[Mesh]:
    """Join a process group as ``rank`` of ``world``, yield the mesh on
    ``device``, and destroy the group on the way out. ``timeout_s`` bounds
    one wait in a collective."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield make_mesh(device=device)
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def single_rank(backend: str, device: str | torch.device) -> Iterator[Mesh]:
    """A world of one rank in this process."""
    with tempfile.TemporaryDirectory(prefix="zns_pg_") as d:
        with process_group(backend, 0, 1, "file://" + os.path.join(d, "store"), device) as mesh:
            yield mesh


def _rank_main(rank, fn, world, backend, device, init_method, collective_timeout_s, out_dir, args):
    if device is None:
        device = f"cuda:{rank}" if backend == "nccl" else "cpu"
    with process_group(backend, rank, world, init_method, device, collective_timeout_s) as mesh:
        try:
            out = fn(mesh, *args)
        except BaseException:
            # Written before this rank leaves the group, so before its failure
            # can make another rank fail in a collective.
            with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
                fh.write(traceback.format_exc())
            raise
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def _tracebacks(out_dir: str, world: int) -> str:
    """Every traceback the ranks wrote, in rank order: a rank that raises
    often makes the others fail in a collective, so the first rank to end
    need not hold the cause."""
    msgs = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as fh:
                msgs.append(f"rank {r} of {world} raised:\n{fh.read()}")
    return "\n".join(msgs)


def run_ranks(fn: Callable, world: int, backend: str, *args, device: Optional[str | torch.device] = None,
              timeout_s: Optional[float] = None, collective_timeout_s: float = TIMEOUT_S) -> list:
    """``fn(mesh, *args)`` on ``world`` spawned ranks; their results, in rank
    order. ``fn`` and ``args`` are pickled (``fn`` by its import path), and
    so are the results. ``device`` None puts rank r on ``cuda:r`` under NCCL
    and on the CPU otherwise; a device puts every rank there (gloo ranks may
    share one card). A rank that raises or dies stops the others, and this
    raises with every rank's traceback. ``collective_timeout_s`` bounds one
    wait in a collective; ``timeout_s`` (None: no limit) bounds the run."""
    with tempfile.TemporaryDirectory(prefix="zns_pg_") as d:
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, world, backend, device, "file://" + os.path.join(d, "store"), collective_timeout_s, d, args))
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while not ctx.join(None if deadline is None else max(0.0, deadline - time.monotonic()),
                               grace_period=_FAIL_GRACE_S):
                if deadline is not None and time.monotonic() >= deadline:
                    raise TimeoutError(f"the {world} ranks did not end within {timeout_s} s")
        except ProcessException as e:
            raise RuntimeError(_tracebacks(d, world) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
    return out


def launch(fn: Callable, device: str | torch.device, *args):
    """``fn(mesh, *args)`` on every rank of the data-parallel world (see the
    module docstring); returns this process's rank's result, or rank 0's
    when the ranks were spawned. ``cuda`` without a card raises."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if all(k in os.environ for k in TORCHRUN_ENV):
        world = int(os.environ["WORLD_SIZE"])
        if int(os.environ.get("LOCAL_WORLD_SIZE", world)) != world:
            raise NotImplementedError(f"a world of {world} ranks over more than one host: the ranks must share one")
        local = torch.device("cuda", int(os.environ["LOCAL_RANK"])) if dev.type == "cuda" else dev
        with process_group(backend, int(os.environ["RANK"]), world, "env://", local) as mesh:
            return fn(mesh, *args)
    if dev.type == "cuda":
        return run_ranks(fn, torch.cuda.device_count(), backend, *args)[0]
    with single_rank(backend, dev) as mesh:
        return fn(mesh, *args)
