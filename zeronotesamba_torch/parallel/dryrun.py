"""The single-device entry and the multichip dry run (port of __graft_entry__.py).

``entry()`` returns the flagship inference forward, a FusedDownstream on two
log-VQT streams, and its example arguments on the card. ``dryrun_multichip(n)``
spawns n ranks (parallel/launch.run_ranks) and runs the REAL training steps
of both engines on a sweep of (data x time x model) meshes, holding each
against the single-device step with the JAX dry run's limits:

1. the pretext contrastive step: a two-step loss trajectory on the pure
   data-parallel mesh and one step on a mixed mesh (``_factorizations``),
   each loss within 1e-4 relative of the single-device trajectory; with
   ``ZNS_DRYRUN_FULL`` set (read as the JAX dry run reads it), three steps
   on each of three meshes;
2. the track-parallel staged pretext step on an (n, 1, 1) mesh, each rank
   holding its shard of the bank, against the single-device step over the
   same n tracks, 1e-4 relative;
3. the supervised step over (n/2, 2, 1): the eval loss with the log-VQT
   sharded over songs and frames, 1e-4 relative, then one train step with
   dropout on;
4. the tensor-parallel ``DSCNN`` forward over (1, 1, n), its conv channels
   sharded by ``shard_params_tp``, at rtol 1e-4 and atol 1e-5.

The single-device references are computed up front, each on one rank (the
j-th on rank j mod n), and shared. Every rank holds every check. Rank 0
prints a lap line to stderr after each stage, as the JAX dry run does.

On the CPU the ranks are gloo processes. On the card they are NCCL ranks,
one a card, or, with more ranks than cards, gloo ranks sharing ``cuda:0``
(NCCL refuses two ranks on one device). The JAX dry run's 16-device
confirmation stage is not ported: it runs only where 16 devices exist, and
this dry run takes n from its caller.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from zeronotesamba_torch.device import disable_tf32, resolve_device
from zeronotesamba_torch.models.encoder import DSCNN, FusedDownstream
from zeronotesamba_torch.parallel.launch import run_ranks
from zeronotesamba_torch.parallel.mesh import Mesh, make_mesh, replicated, shard_batch, shard_params_tp, \
    spectrogram_sharding
from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step, \
    make_train_step
from zeronotesamba_torch.train.supervised import SupervisedConfig, dropout_generator, eval_step, init_state, \
    train_step

ENTRY_FRAMES = 313
CROP = 16  # the JAX dry run's crop: wider than every conv's time half-width
LOSS_RTOL = 1e-4
TP_TOL = dict(rtol=1e-4, atol=1e-5)


def entry(device: str | torch.device = "cuda"):
    """``(fn, (params, anc, pos))``: ``fn(params, anc, pos)`` is the
    FusedDownstream forward (dropout off, no gradient) on two (2, 1, 96, 313)
    streams, ``params`` its state dict (He-normal weights drawn from seed 0),
    ``anc`` and ``pos`` the JAX entry's inputs (``default_rng(0)``), all on
    ``device``."""
    dev = resolve_device(device)
    disable_tf32()
    model = FusedDownstream()
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(dev).eval()

    def fn(params, anc, pos):
        with torch.no_grad():
            return torch.func.functional_call(model, params, (anc, pos))

    rng = np.random.default_rng(0)
    anc, pos = (torch.tensor(rng.standard_normal((2, 96, ENTRY_FRAMES, 1)).astype(np.float32)
                             .transpose(0, 3, 1, 2).copy(), device=dev) for _ in range(2))
    return fn, (dict(model.state_dict()), anc, pos)


def _factorizations(n: int, full: bool = False):
    """(data, time, model, n_steps) mesh stages of the pretext sweep, the
    JAX dry run's: pure data parallelism with a two-step trajectory, then
    one mixed shape that exercises the time and model axes together at one
    step; ``full`` (``ZNS_DRYRUN_FULL``) adds an (n/2, 2, 1) shape and runs
    every shape three steps."""
    steps_mixed = 3 if full else 1
    shapes = [(n, 1, 1, 3 if full else 2)]
    if n % 2 == 0 and full:
        shapes += [(n // 2, 2, 1, 3)]
    if n % 4 == 0:
        shapes += [(n // 4, 2, 2, steps_mixed)]
    elif n % 2 == 0:
        shapes += [(n // 2, 1, 2, steps_mixed)]
    return shapes


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _close(got: float, ref: float, what: str) -> None:
    _check(abs(got - ref) <= LOSS_RTOL * max(1.0, abs(ref)), f"{what} diverged: {got} vs {ref}")


def _inputs(n: int, full: bool = False) -> dict:
    """Every stage's host data, drawn in the JAX dry run's order: the
    pretext batches (three with ``full``, else two) first."""
    rng = np.random.default_rng(0)
    inp = dict(batches=[rng.standard_normal((8, 2, 96, CROP)).astype(np.float32) for _ in range(3 if full else 2)])
    bank = rng.standard_normal((2 * n, 2, 96, 2 * CROP)).astype(np.float32)
    local = rng.integers(0, 2, size=n)
    inp.update(bank=bank, local=local, global_idx=np.arange(n) * 2 + local,
               starts=rng.integers(0, CROP + 1, size=(n, 4)))
    b = max(2, n // 2)
    inp.update(vqt=rng.standard_normal((b, 2, 96, 64)).astype(np.float32),
               pulse=(rng.uniform(size=(b, 64)) < 0.1).astype(np.float32), mask=np.ones((b, 64), np.float32),
               tp_x=rng.standard_normal((2, 1, 96, 32)).astype(np.float32))
    return inp


def _pretext_cfg(batch: int) -> PretextConfig:
    return PretextConfig(batch_size=batch, crop_frames=CROP, dropout_rate=0.0)


def _ref_pretext(inp, dev):
    st, step, traj = init_pretext_state(_pretext_cfg(8), 0, device=dev), make_train_step(_pretext_cfg(8)), []
    for b in inp["batches"]:
        st, loss, _, _ = step(st, torch.as_tensor(b, device=dev), None)
        traj.append(loss.item())
    return traj


def _ref_track(inp, dev):
    st = init_pretext_state(_pretext_cfg(4), 0, device=dev)
    _, loss, _, _ = make_staged_train_step(_pretext_cfg(4))(st, torch.as_tensor(inp["bank"], device=dev),
                                                              inp["global_idx"], inp["starts"], None)
    return loss.item()


def _supervised_state(dev):
    return init_state(SupervisedConfig(status="pretrained", lr=1e-4, bucket_frames=64), None, 2, device=dev)


def _ref_supervised(inp, dev):
    loss, _ = eval_step(_supervised_state(dev), *(torch.as_tensor(inp[k], device=dev)
                                                  for k in ("vqt", "pulse", "mask")), "pretrained")
    return loss.item()


def _tp_model(dev) -> DSCNN:
    model = DSCNN()
    model.reset_parameters(torch.Generator().manual_seed(4))
    return model.to(dev).eval()


def _ref_tp(inp, dev):
    with torch.no_grad():
        return _tp_model(dev)(torch.as_tensor(inp["tp_x"], device=dev)).cpu().numpy()


REFERENCES = (("pretext", _ref_pretext), ("track", _ref_track), ("supervised", _ref_supervised), ("tp", _ref_tp))


def _rank(mesh: Mesh, t_start: float, full: bool) -> list:
    """Every stage on one rank of the world; the laps, on rank 0."""
    n, dev = dist.get_world_size(), mesh.device
    disable_tf32()  # every stage is float32, its reference too
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    laps = []

    def lap(stage: str, msg: str) -> None:
        laps.append(dict(stage=stage, seconds=time.time() - t_start, msg=msg))
        if mesh.flat_rank == 0:
            print(f"[dryrun {laps[-1]['seconds']:6.1f}s] {msg}", file=sys.stderr, flush=True)

    inp = _inputs(n, full)
    mine = {name: fn(inp, dev) for j, (name, fn) in enumerate(REFERENCES) if j % n == mesh.flat_rank}
    gathered = [None] * n
    dist.all_gather_object(gathered, mine)
    ref = {k: v for part in gathered for k, v in part.items()}
    lap("references", f"single-device references; pretext trajectory {[f'{v:.5f}' for v in ref['pretext']]}")

    # 1. The pretext step on the mesh sweep, at dropout 0.
    for d, t, m, k_steps in _factorizations(n, full):
        label = f"mesh {d}x{t}x{m}"
        pmesh = make_mesh(d, t, m, device=dev)
        st, step = init_pretext_state(_pretext_cfg(8), 0, device=dev), make_train_step(_pretext_cfg(8), pmesh)
        for i, b in enumerate(inp["batches"][:k_steps]):
            st, loss, _, _ = step(st, b, None)
            _close(loss.item(), ref["pretext"][i], f"pretext loss on {label} at step {i}")
        lap("pretext", f"pretext {k_steps}-step trajectory on {label}: parity ok")

    # 2. The track-parallel staged step: each rank holds its shard of the bank.
    tmesh = make_mesh(n, 1, 1, device=dev)
    st = init_pretext_state(_pretext_cfg(4), 0, device=dev)
    _, loss, _, _ = make_staged_train_step(_pretext_cfg(4), tmesh)(st, shard_batch(tmesh, inp["bank"]), inp["local"],
                                                                    inp["starts"], None)
    _close(loss.item(), ref["track"], "track-parallel staged step")
    lap("track", f"track-parallel sharded-bank step ({n} tracks): loss={loss.item():.5f} (parity ok)")

    # 3. The supervised step over songs and frames.
    smesh = make_mesh(n // 2, 2, 1, device=dev)
    place = spectrogram_sharding(smesh)
    vqt, pulse, mask = (place(inp[k]) for k in ("vqt", "pulse", "mask"))
    sstate = _supervised_state(dev)
    eloss, _ = eval_step(sstate, vqt, pulse, mask, "pretrained", mesh=smesh)
    _close(eloss.item(), ref["supervised"], "supervised dp x sp eval loss")
    _, loss, _ = train_step(sstate, vqt, pulse, mask, dropout_generator(3, 0, dev), "pretrained", mesh=smesh)
    _check(bool(torch.isfinite(loss)), f"supervised dp x sp train step loss {loss.item()}")
    lap("supervised", f"supervised dpxsp eval parity + train step: loss={eloss.item():.5f}")

    # 4. The tensor-parallel forward: every conv's output channels sharded.
    tp_mesh = make_mesh(1, 1, n, device=dev)
    model = shard_params_tp(tp_mesh, _tp_model(dev))
    with torch.no_grad():
        out = model(replicated(tp_mesh)(inp["tp_x"]), mesh=tp_mesh).cpu().numpy()
    np.testing.assert_allclose(out, ref["tp"], **TP_TOL)
    lap("tp", "tp (model-axis) forward parity ok; dryrun complete")
    return laps


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda") -> list:
    """Run the dry run on ``n_devices`` spawned ranks (an even number: the
    supervised stage splits the world in two over the time axis); any failed
    check raises. ``ZNS_DRYRUN_FULL`` set to anything but the empty string
    runs the full pretext sweep. Returns rank 0's laps: each stage's name,
    the seconds since the start at which it ended and its message."""
    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"the dry run needs an even number of ranks, not {n_devices}")
    dev = resolve_device(device)
    if dev.type == "cpu":
        backend, rank_device = "gloo", "cpu"
    elif n_devices <= torch.cuda.device_count():
        backend, rank_device = "nccl", None
    else:
        backend, rank_device = "gloo", "cuda:0"
    full = bool(os.environ.get("ZNS_DRYRUN_FULL"))
    return run_ranks(_rank, n_devices, backend, time.time(), full, device=rank_device)[0]
