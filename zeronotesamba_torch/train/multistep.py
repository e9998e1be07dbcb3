"""K optimizer steps in one call: the port's multi-step dispatch.

The JAX engines run ``steps_per_call`` optimizer steps as one executed
program, a ``lax.scan`` over the steps (zeronotesamba_tpu/train/
supervised.make_multistep_train_step, train/pretext.make_staged_train_step).
Here ``run_steps`` takes the place of that scan:

- on CPU tensors it runs the K steps one after another: the plain version,
  which the tests use;
- on CUDA tensors its first call captures the K steps (each one
  ``zero_grad``, forward, backward and ``optimizer.step()``) as one
  ``torch.cuda.CUDAGraph``, and every later call replays that graph. The host
  then launches nothing of a step, and the caller reads the K steps' results
  once. A capture that fails raises: no path falls back to the eager loop.

What a graph bakes in, and how it stays right:

- Addresses. A replay reads the parameters, the buffers, the optimizer's
  state and the data tensors (a staged bucket, a bank) where they were at
  the capture; Adam must be ``capturable`` (train/state.py). The per-step
  inputs (row or track indices, shift starts) are copied into the graph's
  own tensors before a replay, and its results are copied out after it.
- The cache. Graphs live on the TrainState (``state.graphs``), keyed by what
  the step reads (the engine, the data tensors, the shapes, dropout on or
  off). Each keeps the signature of the state it was captured on: those
  addresses, the optimizer's hyperparameters and the cuDNN and TF32
  switches. A call on a state that no longer matches it (a resume's
  ``optimizer.load_state_dict``, another lr) drops every graph of that state
  and captures anew, so no stale graph is replayed.
- Dropout. Step s draws its masks from ``generators[s]``, as the eager step
  does. The graph holds K generators of its own, registered with it; before
  a replay each takes the state of the caller's generator of that step, so
  the replay draws the eager steps' masks, and after it the caller's
  generators are left as the eager steps would leave them.
- Warm-up. One plain step on the capture stream before the capture creates
  the optimizer's state and the libraries' handles outside the graph's
  memory; the parameters, buffers, optimizer state and step count are then
  put back in place, so the first call computes what K eager steps would.
- Memory. Every graph of the process on one card shares one memory pool.
  A replay reads nothing of the pool that it has not written itself first,
  so graphs of other buckets or states may reuse each other's blocks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from zeronotesamba_torch.train.state import TrainState
from zeronotesamba_torch.utils import profiling

WARMUP_STEPS = 1
# Graph captures and replays of this process (``profiling.totals("multistep.")``), as the kernels count launches.
profiling.count("multistep.captures", 0)
profiling.count("multistep.replays", 0)
_POOLS: Dict[int, tuple] = {}
_STREAMS: Dict[int, "torch.cuda.Stream"] = {}

StepFn = Callable[[int, Tuple[torch.Tensor, ...], Optional[torch.Generator]], Tuple[torch.Tensor, ...]]


@dataclasses.dataclass
class _Graph:
    graph: "torch.cuda.CUDAGraph"
    signature: tuple
    inputs: Tuple[torch.Tensor, ...]  # the per-step inputs' static copies, (K, ...) each
    generators: Optional[List[torch.Generator]]
    outputs: Tuple[torch.Tensor, ...]  # the K steps' results, stacked
    keep: tuple  # the data tensors the graph reads, held so their ids stay theirs
    seconds: float  # host clock over the warm-up and the capture


def _hashable(v) -> bool:
    try:
        hash(v)
    except TypeError:
        return False
    return True


def state_signature(state: TrainState) -> tuple:
    """What a captured graph depends on besides its inputs."""
    opt = state.optimizer
    groups = []
    for g in opt.param_groups:
        hyper = tuple(sorted((k, v) for k, v in g.items() if k != "params" and _hashable(v)))
        held = tuple((p.data_ptr(), tuple((k, v.data_ptr()) for k, v in sorted(opt.state.get(p, {}).items())
                                          if torch.is_tensor(v))) for p in g["params"])
        groups.append((hyper, held))
    params = tuple((p.data_ptr(), p.requires_grad) for p in state.model.parameters())
    buffers = tuple(b.data_ptr() for b in state.model.buffers())
    switches = (torch.backends.cudnn.enabled, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision())
    return id(state.model), id(opt), tuple(groups), params, buffers, switches


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


def _snapshot(state: TrainState):
    tensors = [*state.model.parameters(), *state.model.buffers()]
    opt = {p: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in st.items()}
           for p, st in state.optimizer.state.items()}
    return tensors, [t.detach().clone() for t in tensors], opt, state.step


def _restore(state: TrainState, saved) -> None:
    """Put a snapshot back in place. Optimizer state that the warm-up created
    is zeroed: Adam's lazily created state is zeros."""
    tensors, copies, opt, step = saved
    with torch.no_grad():
        for t, c in zip(tensors, copies):
            t.copy_(c)
        for p, st in state.optimizer.state.items():
            before = opt.get(p)
            for k, v in st.items():
                if torch.is_tensor(v):
                    v.zero_() if before is None else v.copy_(before[k])
                elif before is not None:
                    st[k] = before[k]
    state.step = step


def _capture(state: TrainState, step_fn: StepFn, inputs, generators, device: torch.device, keep) -> _Graph:
    t0 = time.perf_counter()
    idx = _index(device)
    if idx not in _STREAMS:
        _STREAMS[idx], _POOLS[idx] = torch.cuda.Stream(device=device), torch.cuda.graph_pool_handle()
    stream, pool = _STREAMS[idx], _POOLS[idx]
    k = len(generators)
    static = tuple(torch.as_tensor(x).to(device).clone() for x in inputs)
    gens = None if generators[0] is None else [torch.Generator(device=device) for _ in range(k)]
    saved = _snapshot(state)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for s in range(min(WARMUP_STEPS, k)):
            step_fn(s, static, None if gens is None else gens[s])
    torch.cuda.current_stream(device).wait_stream(stream)
    _restore(state, saved)
    graph = torch.cuda.CUDAGraph()
    for g in gens or ():
        graph.register_generator_state(g)
    state.optimizer.zero_grad(set_to_none=True)
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            steps = [step_fn(s, static, None if gens is None else gens[s]) for s in range(k)]
            outputs = tuple(torch.stack(col) for col in zip(*steps))
    finally:
        state.step = saved[3]  # the capture ran no step
    profiling.count("multistep.captures")
    return _Graph(graph, state_signature(state), static, gens, outputs, tuple(keep), time.perf_counter() - t0)


def run_steps(state: TrainState, key: tuple, step_fn: StepFn, inputs: Sequence, generators: Sequence,
              device: torch.device, keep: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
    """K = len(generators) optimizer steps on ``state``, in order; returns
    each result of ``step_fn`` stacked over the steps, (K, ...).

    ``step_fn(s, inputs, generator)`` takes one whole optimizer step (a
    train step of the engine, which updates ``state`` in place) on step s's
    slice of ``inputs`` (tensors, (K, ...) each) and returns its results.
    ``generators`` are the steps' dropout generators, all None for dropout
    off. ``device`` is where the data lies: CPU runs the plain loop, CUDA a
    graph cached on ``state`` under ``key`` (module docstring), which holds
    ``keep``, the data tensors it reads."""
    generators = list(generators)
    if any((g is None) != (generators[0] is None) for g in generators):
        raise ValueError("dropout generators must be given for every step or for none")
    if device.type == "cpu":
        inputs = tuple(torch.as_tensor(x) for x in inputs)
        steps = [step_fn(s, inputs, g) for s, g in enumerate(generators)]
        return tuple(torch.stack(col) for col in zip(*steps))
    if device.type != "cuda":
        raise ValueError(f"multi-step dispatch runs on the CPU or a CUDA card, not {device}")
    key = (*key, generators[0] is not None)
    entry = state.graphs.get(key)
    if entry is not None and entry.signature != state_signature(state):
        state.graphs.clear()
        entry = None
    if entry is None:
        entry = state.graphs[key] = _capture(state, step_fn, inputs, generators, device, keep)
    for static, x in zip(entry.inputs, inputs):
        x = torch.as_tensor(x)
        static.copy_(x.pin_memory() if x.device.type == "cpu" else x, non_blocking=True)
    for mine, theirs in zip(entry.generators or (), generators):
        mine.set_state(theirs.get_state())
    entry.graph.replay()
    profiling.count("multistep.replays")
    outputs = tuple(t.clone() for t in entry.outputs)
    for mine, theirs in zip(entry.generators or (), generators):
        theirs.set_state(mine.get_state())
    state.step += len(generators)
    return outputs
