"""The port's pretext driver under a data-parallel mesh against the JAX
package's: the bank's shards after the modular pad, and two epochs of
``train_pretext(mesh=...)`` track-parallel over two ranks, k = 2, from the
same seed and initial weights at dropout 0 (tests/test_torch_pretext.py's
monkeypatched-init pattern).

The port runs in a world of two gloo ranks on the CPU spawned for this
module (``run_ranks``); JAX runs in this process on a mesh of two of
conftest's CPU devices, and is imported only inside the references, so the
spawned ranks do not load it. The driver runs the full-width twin (about
2.5 GFLOP a frame) at batch 2, crops of 8 frames, bank items of 16, on a
15-track train bank (padded to 16) and one validation track.

Tolerances: bank shards exact; both ranks' histories and best parameters
equal; the histories 1e-3 relative and the restarts equal to JAX's; the
best parameters within 2 lr an update plus float32 rounding of JAX's. JAX
runs with its gradient divided by d before Adam (``jax_init`` below says
why).
"""

import dataclasses

import numpy as np
import pytest
import torch

from zeronotesamba_torch.experiments import pretext_driver as pdrv
from zeronotesamba_torch.models.weights import state_dict_from_jax
from zeronotesamba_torch.parallel.launch import run_ranks
from zeronotesamba_torch.parallel.mesh import Mesh, host_array_from_rank0

torch.set_num_threads(2)

WORLD, K = 2, 2
FRAMES, TRACKS = 16, 15
INIT_KEY = 1
EPS = float(np.finfo(np.float32).eps)
LR = 1e-4  # tests/test_torch_pretext.py's; the reference's 1e-6 barely moves a weight in 8 updates
DRIVER = dict(task="zerons", num_epochs=2, batch_size=2, crop_frames=8, lr=LR, seed=0, tracks_per_step=K)


def _bank(n, frames, seed):
    return (np.random.default_rng(seed).standard_normal((n, 2, 96, frames)) * 4.0 - 6.0).astype(np.float32)


def _rank_driver(mesh, twin, train, val):
    """The bank shard and two epochs of train_pretext on one rank, from
    ``twin`` at dropout 0. As in ``pretext --data-parallel``, rank 1 trains
    on rank 0's train bank mapped from a file, and has no validation bank."""
    torch.set_num_threads(2)
    train = host_array_from_rank0(train if mesh.rank == 0 else None, mesh)
    val = val if mesh.rank == 0 else None
    p_init = pdrv.init_pretext_state

    def init(pcfg, seed, **kw):
        return p_init(dataclasses.replace(pcfg, dropout_rate=0.0), seed, params=twin, **kw)

    pdrv.init_pretext_state = init
    try:
        best, hist = pdrv.train_pretext(train, val, pdrv.PretextRunConfig(**DRIVER), mesh=mesh)
    finally:
        pdrv.init_pretext_state = p_init
    return dict(rank=mesh.rank, mapped=isinstance(train, np.memmap), shard=pdrv.shard_bank(train, mesh).numpy(),
                hist=hist,
                best={k: v.numpy() for k, v in best.items()})


@pytest.fixture(scope="module")
def twin():
    """The JAX TwinPretext's initial params (numpy), dropout 0."""
    import jax

    from zeronotesamba_tpu.train import pretext as jpre

    cfg = jpre.PretextConfig(batch_size=DRIVER["batch_size"], crop_frames=DRIVER["crop_frames"], dropout_rate=0.0)
    return jax.tree_util.tree_map(np.asarray, jpre.init_pretext_state(cfg, jax.random.PRNGKey(INIT_KEY)).params)


@pytest.fixture(scope="module")
def bank():
    return _bank(TRACKS + 1, FRAMES, seed=1)


@pytest.fixture(scope="module")
def ranks(twin, bank):
    return run_ranks(_rank_driver, WORLD, "gloo", twin, bank[:TRACKS], bank[TRACKS:], timeout_s=600)


def test_bank_shards_after_the_modular_pad(ranks, bank):
    train = bank[:TRACKS]
    n_pad = (-len(train)) % WORLD
    padded = np.concatenate([train, np.take(train, np.arange(n_pad) % len(train), axis=0)])  # the JAX driver's pad
    s = len(padded) // WORLD
    assert [r["mapped"] for r in ranks] == [False, True]
    for r in ranks:
        assert r["shard"].shape == (s, 2, 96, FRAMES)
        np.testing.assert_array_equal(r["shard"], padded[r["rank"] * s: (r["rank"] + 1) * s])
    small = _bank(3, 4, seed=3)
    for d, rows in ((8, [0, 1, 2, 0, 1, 2, 0, 1]), (3, [0, 1, 2])):  # at d = 8 more pad rows (5) than the bank has
        meshes = [Mesh({"data": d, "time": 1, "model": 1}, r, torch.device("cpu")) for r in range(d)]
        np.testing.assert_array_equal(np.concatenate([pdrv.shard_bank(small, m).numpy() for m in meshes]),
                                      small[rows])


def test_train_pretext_on_a_mesh_matches_jax(ranks, bank, twin, monkeypatch):
    import jax
    import optax

    from zeronotesamba_tpu.experiments import pretext_driver as jdrv
    from zeronotesamba_tpu.parallel.mesh import make_mesh
    from zeronotesamba_tpu.train import pretext as jpre
    from zeronotesamba_tpu.train.state import TrainState, pretext_optimizer

    def jax_init(pcfg, rng):
        """The port's ranks' weights, and Adam behind a 1/d gradient scale:
        JAX's mesh step hands its optimizer d times the mean loss's gradient
        (tests/test_torch_mesh.py), which Adam's first step ignores but its
        eps (1e-8) does not, at these near-plateau gradients of 1e-9 to 1e-7."""
        del rng
        tx = optax.chain(optax.scale(1.0 / WORLD), pretext_optimizer(pcfg.task, pcfg.lr))
        return TrainState.create(apply_fn=jpre.make_pretext_model(pcfg.task, 0.0).apply, params=twin, tx=tx)

    monkeypatch.setattr(jdrv, "init_pretext_state", jax_init)
    j_best, j_hist = jdrv.train_pretext(bank[:TRACKS], bank[TRACKS:], jdrv.PretextRunConfig(**DRIVER),
                                        mesh=make_mesh(data=WORLD, devices=jax.devices()[:WORLD]))
    h0, h1 = ranks[0]["hist"], ranks[1]["hist"]
    assert h0 == h1
    for key in ("train_loss", "val_loss", "train_pos", "train_neg", "val_pos", "val_neg"):
        assert len(h0[key]) == DRIVER["num_epochs"]
        np.testing.assert_allclose(h0[key], j_hist[key], rtol=1e-3, err_msg=key)
    assert h0["restarts"] == j_hist["restarts"] == []
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_best))
    assert set(ranks[0]["best"]) == set(ref)
    updates = DRIVER["num_epochs"] * (TRACKS + 1) // WORLD // K
    for name, v in ranks[0]["best"].items():
        np.testing.assert_array_equal(ranks[1]["best"][name], v, err_msg=name)
        np.testing.assert_allclose(v, ref[name].numpy(), rtol=2 * updates * EPS, atol=2 * LR * updates, err_msg=name)
