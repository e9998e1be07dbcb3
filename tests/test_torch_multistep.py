"""Multi-step dispatch (``steps_per_call``) in the port against the JAX
package: K optimizer steps in one call for the supervised and the pretext
engines, ``run_epoch``'s grouping of a batch plan, and the pretext driver's
S-chunk schedule. On the CPU a K-step call is the plain loop of K steps (on
the card it replays one CUDA graph, tests/test_torch_cuda.py). JAX runs its
scans unrolled, as tests/test_train.py does on the CPU; dropout is 0 where
the two packages are compared, since their masks match only in
distribution.

Tolerances:
- the K = 3 supervised step and the S = 3 pretext step against JAX's:
  losses (and the pretext cosines) 1e-5 relative, the supervised
  parameters within 1e-6 (the JAX package's own scan-vs-sequential limit)
  and outputs 2e-5 (one step's, tests/test_torch_train.py); against the
  port's own single steps bit for bit. Both run at lr 1e-6, the reference's
  pretext rate: Adam moves a weight whose gradient lies within float32
  rounding of zero by up to lr either way, so at lr 1e-4 one supervised
  weight ended 2e-4 from JAX's after three steps (at 1e-5 2.9e-6, at 1e-6
  2.4e-7). The pretext twin's gradients near its ln(B) plateau are 1e-9
  to 1e-7, a few times Adam's eps, and even at 1e-6 17 of 2,112 weights of
  one conv ended up to 3.9e-6 from JAX's: its parameters are held at 2 lr
  an update plus float32 rounding, tests/test_torch_pretext.py's limit;
- ``run_epoch`` with steps_per_call 2 and 3 against steps_per_call 1 on the
  CPU, dropout on: equal bit for bit; its groups equal JAX's;
- ``train_pretext`` at S = 4 against JAX's, on an epoch of 5 updates padded
  to 8: the same update count, histories 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.experiments import pretext_driver as jdrv
from zeronotesamba_torch.experiments import pretext_driver as pdrv

torch.set_num_threads(2)

B, CROP, FRAMES = 2, 8, 16  # pretext batch, crop and bank item frames
LR = 1e-6  # the reference's pretext rate; module docstring
INIT_KEY = 1
EPS = float(np.finfo(np.float32).eps)


def _bank(n, frames=FRAMES, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, 2, 96, frames)) * 4.0 - 6.0).astype(np.float32)


def _counting(make_step, counts):
    """Wrap a package's make_staged_train_step so every call adds the
    number of updates it ran (its leading track-index dimension when it
    runs several, else one) to ``counts``."""

    def factory(*args, **kwargs):
        step = make_step(*args, **kwargs)
        multi = kwargs.get("steps_per_call", 1) > 1

        def counted(state, bank, track_idx, starts, *rest):
            counts.append(int(np.shape(track_idx)[0]) if multi else 1)
            return step(state, bank, track_idx, starts, *rest)

        return counted

    return factory


def test_train_pretext_s4_pads_the_epoch_as_jax(monkeypatch):
    """Five train tracks at S = 4: JAX pads the epoch to 8 updates from the
    shuffle stream before it draws the shifts; the port does the same, so
    both run 8 updates on the same crops and give the same histories."""
    bank = _bank(6, seed=3)
    kw = dict(task="zerons", num_epochs=1, batch_size=B, crop_frames=CROP, lr=LR, seed=0, steps_per_call=4)
    start = {}
    j_init, p_init = jdrv.init_pretext_state, pdrv.init_pretext_state

    def jax_init(pcfg, rng):
        state = j_init(dataclasses.replace(pcfg, dropout_rate=0.0), jax.random.PRNGKey(INIT_KEY))
        start["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        return state

    def port_init(pcfg, seed, **kwargs):
        return p_init(dataclasses.replace(pcfg, dropout_rate=0.0), seed, params=start["params"], **kwargs)

    j_counts, p_counts = [], []
    monkeypatch.setattr(jdrv, "init_pretext_state", jax_init)
    monkeypatch.setattr(pdrv, "init_pretext_state", port_init)
    monkeypatch.setattr(jdrv, "make_staged_train_step", _counting(jdrv.make_staged_train_step, j_counts))
    monkeypatch.setattr(pdrv, "make_staged_train_step", _counting(pdrv.make_staged_train_step, p_counts))
    _, j_hist = jdrv.train_pretext(bank[1:], bank[:1], jdrv.PretextRunConfig(**kw, scan_unroll=True))
    _, p_hist = pdrv.train_pretext(bank[1:], bank[:1], pdrv.PretextRunConfig(**kw), device="cpu")
    assert j_counts == [4, 4]
    assert p_counts == j_counts
    for key in ("train_loss", "val_loss", "train_pos", "train_neg", "val_pos", "val_neg"):
        np.testing.assert_allclose(p_hist[key], j_hist[key], rtol=1e-5, err_msg=key)


# -- the supervised engine ---------------------------------------------------

SUP_B, SUP_FRAMES = 2, 32


def _songs(lengths, seed=12):
    """Song records of the given frame counts: log-VQT-like noise, a pulse
    of a few beats, the beats' times."""
    rng = np.random.default_rng(seed)
    out = []
    for j, n in enumerate(lengths):
        beats = np.sort(rng.uniform(0.05, n / 62.5 - 0.05, 3))
        pulse = np.zeros(n, np.float32)
        pulse[np.minimum((beats * 62.5).astype(int), n - 1)] = 1.0
        vqt = (rng.standard_normal((1, 96, n)) * 4.0 - 6.0).astype(np.float32)
        out.append((f"s{j:02d}", vqt, pulse, np.zeros(n, np.float32), beats, np.zeros(0)))
    return out


def _port_staged(songs, bucket_frames=SUP_FRAMES):
    from zeronotesamba_torch.data.datasets import SongRecord
    from zeronotesamba_torch.train.supervised import StagedDataset

    return StagedDataset([SongRecord(*s) for s in songs], bucket_frames, device="cpu")


@pytest.fixture(scope="module")
def sup_params():
    """The JAX DSCNN's initial params (numpy)."""
    from zeronotesamba_tpu.data.datasets import SongRecord as JSongRecord
    from zeronotesamba_tpu.train import supervised as jsup

    cfg = jsup.SupervisedConfig(status="vanilla", lr=LR, bucket_frames=SUP_FRAMES)
    example = JSongRecord(*_songs([SUP_FRAMES])[0])
    return jax.tree_util.tree_map(np.asarray, jsup.init_state(cfg, example, jax.random.PRNGKey(4)).params)


def test_supervised_k3_step_matches_jax(sup_params):
    """One K = 3 call on rows of a staged bucket, dropout 0, against the JAX
    engine's scan of 3 steps from the same params, and against three
    train_step calls of the port (bit for bit on the CPU)."""
    from zeronotesamba_tpu.models.encoder import DSCNN as JDSCNN
    from zeronotesamba_tpu.train import supervised as jsup
    from zeronotesamba_tpu.train.state import TrainState as JTrainState, make_optimizer as jmake_optimizer
    from zeronotesamba_torch.models.weights import state_dict_from_jax
    from zeronotesamba_torch.train.supervised import (
        SupervisedConfig, init_state, make_multistep_train_step, train_step,
    )

    staged = _port_staged(_songs([SUP_FRAMES] * 5))
    bucket = staged.buckets[SUP_FRAMES]
    idx = np.array([[3, 0], [1, 4], [2, 3]], np.int64)
    jstate = JTrainState.create(apply_fn=JDSCNN(dropout_rate=0.0).apply,
                                params=jax.tree_util.tree_map(jnp.asarray, sup_params),
                                tx=jmake_optimizer("vanilla", "finetune", LR))
    jstep = jsup.make_multistep_train_step("vanilla", True)
    jnew, jlosses, jouts = jstep(jstate, *(jnp.asarray(t.numpy()) for t in (bucket.vqt, bucket.pulse, bucket.mask)),
                                 jnp.asarray(idx, jnp.int32), jax.random.split(jax.random.key(0), 3), 1.0)

    cfg = SupervisedConfig(status="vanilla", lr=LR, bucket_frames=SUP_FRAMES)
    state = init_state(cfg, None, 0, params=sup_params, device="cpu")
    state, losses, outs = make_multistep_train_step("vanilla")(state, bucket.vqt, bucket.pulse, bucket.mask, idx,
                                                               [None] * 3)
    assert state.step == 3 and losses.shape == (3,) and outs.shape == (3, SUP_B, SUP_FRAMES)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-5)
    np.testing.assert_allclose(outs.numpy(), np.asarray(jouts), atol=2e-5)
    ref, start = (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p)) for p in (jnew.params, sup_params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0, atol=1e-6, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"

    seq = init_state(cfg, None, 0, params=sup_params, device="cpu")
    for k, rows in enumerate(torch.as_tensor(idx)):
        seq, loss, out = train_step(seq, bucket.vqt[rows], bucket.pulse[rows], bucket.mask[rows], None, "vanilla")
        assert loss.item() == losses[k].item() and torch.equal(out, outs[k])
    assert all(torch.equal(a, b) for a, b in zip(seq.model.parameters(), state.model.parameters()))


# Seven songs in the first bucket (batches 2, 2, 2 and a ragged 1 at batch
# 2) and four in the second (2, 2): K = 2 groups the first two batches of
# each bucket, K = 3 the first three of the first.
EPOCH_LENGTHS = [14] * 7 + [20] * 4
EPOCH_BUCKET = 16
GROUPS = {2: [("multi", 2), ("single", 2), ("single", 1), ("multi", 2)],
          3: [("multi", 3), ("single", 1), ("single", 2), ("single", 2)]}


def _plan(staged, seed=5):
    names = [s[0] for s in _songs(EPOCH_LENGTHS)]
    return staged.plan(names, SUP_B, shuffle_rng=np.random.default_rng(seed))


@pytest.mark.parametrize("k", [2, 3])
def test_run_epoch_groups_as_jax(k, monkeypatch):
    """Which plan entries each engine's run_epoch takes as one K-step call
    and which as single steps, with both engines' steps stubbed out."""
    from zeronotesamba_tpu.data.datasets import SongRecord as JSongRecord
    from zeronotesamba_tpu.train import supervised as jsup
    from zeronotesamba_torch.train import supervised as psup

    songs = _songs(EPOCH_LENGTHS)
    plan = _plan(_port_staged(songs, EPOCH_BUCKET))
    calls = {"jax": [], "port": []}

    def recorder(name, idx_of):
        def make_multi(*args):
            def multi(state, vqt, pulse, mask, idx, *rest):
                calls[name].append(("multi", [list(map(int, r)) for r in np.asarray(idx)]))
                return state, np.zeros(len(idx), np.float32), None
            return multi

        def single(state, vqt, pulse, mask, *rest):
            calls[name].append(("single", [list(map(int, idx_of(vqt)))]))
            return state, np.float32(0.0), None
        return make_multi, single

    j_multi, j_single = recorder("jax", np.asarray)
    monkeypatch.setattr(jsup, "make_multistep_train_step", j_multi)
    monkeypatch.setattr(jsup, "train_step", j_single)
    monkeypatch.setattr(jsup, "_gather", lambda arr, idx: idx)  # the single step sees its rows
    p_multi, p_single = recorder("port", lambda rows: rows.numpy())
    monkeypatch.setattr(psup, "make_multistep_train_step", p_multi)
    monkeypatch.setattr(psup, "train_step", p_single)
    monkeypatch.setattr(torch.Tensor, "index_select", lambda arr, dim, idx: idx)

    jcfg = jsup.SupervisedConfig(status="vanilla", batch_size=SUP_B, bucket_frames=EPOCH_BUCKET, steps_per_call=k)
    jsup.run_epoch(None, jsup.StagedDataset([JSongRecord(*s) for s in songs], EPOCH_BUCKET), plan, jcfg,
                   train=True, score=False)
    pcfg = psup.SupervisedConfig(status="vanilla", batch_size=SUP_B, bucket_frames=EPOCH_BUCKET, steps_per_call=k)
    psup.run_epoch(None, _port_staged(songs, EPOCH_BUCKET), plan, pcfg, train=True, score=False)
    assert calls["port"] == calls["jax"]
    assert [(kind, len(rows) if kind == "multi" else len(rows[0])) for kind, rows in calls["port"]] == GROUPS[k]


def test_run_epoch_k_steps_equal_single_steps():
    """One epoch with dropout on (rate 0.1, seeded) and scoring: K = 2 and
    K = 3 give K = 1's loss, metrics and parameters bit for bit."""
    from zeronotesamba_torch.train.supervised import SupervisedConfig, init_state, run_epoch

    staged = _port_staged(_songs(EPOCH_LENGTHS), EPOCH_BUCKET)
    runs = {}
    for k in (1, 2, 3):
        cfg = SupervisedConfig(status="vanilla", lr=1e-3, batch_size=SUP_B, bucket_frames=EPOCH_BUCKET,
                               eval_method="threshold", dropout_seed=3, steps_per_call=k)
        state = init_state(cfg, None, 7, device="cpu")
        state, loss, metrics = run_epoch(state, staged, _plan(staged), cfg, train=True, epoch=1, score=True)
        runs[k] = (loss, metrics.tolist(), [p.detach().clone() for p in state.model.parameters()], state.step)
    for k in (2, 3):
        assert runs[k][:2] == runs[1][:2] and runs[k][3] == runs[1][3] == 6
        assert all(torch.equal(a, b) for a, b in zip(runs[k][2], runs[1][2]))


# -- the pretext engine --------------------------------------------------------

S_TRACKS = np.array([2, 0, 1])


def _s_starts():
    return np.random.default_rng(4).integers(0, FRAMES - CROP + 1, size=(3, B))


def test_pretext_s3_step_matches_jax():
    """One S = 3 staged call at dropout 0 against the JAX engine's scan of 3
    steps from the same params, and against three single steps of the port
    (bit for bit on the CPU)."""
    from zeronotesamba_tpu.train import pretext as jpre
    from zeronotesamba_torch.models.weights import state_dict_from_jax
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step

    bank = _bank(3, seed=2)
    jcfg = jpre.PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0, lr=LR)
    jstate = jpre.init_pretext_state(jcfg, jax.random.PRNGKey(INIT_KEY))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    jnew, jl, jpc, jnc = jpre.make_staged_train_step(jcfg, steps_per_call=3, scan_unroll=True)(
        jstate, jnp.asarray(bank), jnp.asarray(S_TRACKS, jnp.int32), jnp.asarray(_s_starts(), jnp.int32),
        jax.random.key(0))

    cfg = PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0, lr=LR)
    state = init_pretext_state(cfg, 0, params=params, device="cpu")
    state, losses, pcs, ncs = make_staged_train_step(cfg, steps_per_call=3)(state, torch.tensor(bank), S_TRACKS,
                                                                            _s_starts(), [None] * 3)
    assert state.step == 3 and losses.shape == pcs.shape == ncs.shape == (3,)
    for got, want in ((losses, jl), (pcs, jpc), (ncs, jnc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    ref, start = (state_dict_from_jax(jax.tree_util.tree_map(np.asarray, p)) for p in (jnew.params, params))
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=2 * 3 * EPS, atol=2 * 3 * LR,
                                   err_msg=name)
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"

    seq, single = init_pretext_state(cfg, 0, params=params, device="cpu"), make_staged_train_step(cfg)
    for s in range(3):
        seq, loss, pc, nc = single(seq, torch.tensor(bank), S_TRACKS[s], _s_starts()[s], None)
        assert [loss.item(), pc.item(), nc.item()] == [losses[s].item(), pcs[s].item(), ncs[s].item()]
    assert all(torch.equal(a, b) for a, b in zip(seq.model.parameters(), state.model.parameters()))


def test_pretext_k2_track_steps_with_dropout_equal_single_steps():
    """S = 2 calls of the k = 2 track step with dropout on: the single
    steps' losses and parameters bit for bit, and the generators left as
    the single steps leave them."""
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step
    from zeronotesamba_torch.train.supervised import dropout_generator

    bank = torch.tensor(_bank(4, seed=6))
    tracks = np.array([[0, 3], [2, 1]])
    starts = np.random.default_rng(8).integers(0, FRAMES - CROP + 1, size=(2, 2, B))
    cfg = PretextConfig(batch_size=B, crop_frames=CROP, lr=1e-3)
    multi, multi_gens = init_pretext_state(cfg, 5, device="cpu"), [dropout_generator(9, s, "cpu") for s in range(2)]
    multi, losses, _, _ = make_staged_train_step(cfg, steps_per_call=2)(multi, bank, tracks, starts, multi_gens)
    seq, single = init_pretext_state(cfg, 5, device="cpu"), make_staged_train_step(cfg)
    for s in range(2):
        gen = dropout_generator(9, s, "cpu")
        seq, loss, _, _ = single(seq, bank, tracks[s], starts[s], gen)
        assert loss.item() == losses[s].item()
        assert torch.equal(gen.get_state(), multi_gens[s].get_state())
    assert all(torch.equal(a, b) for a, b in zip(seq.model.parameters(), multi.model.parameters()))


def test_multistep_refuses_a_mesh_and_mixed_dropout():
    from zeronotesamba_torch.parallel.mesh import Mesh
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step

    cfg = PretextConfig(batch_size=B, crop_frames=CROP)
    mesh = Mesh({"data": 2, "time": 1, "model": 1}, 0, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="single-device"):
        make_staged_train_step(cfg, mesh=mesh, steps_per_call=2)
    make_staged_train_step(cfg, mesh=mesh, steps_per_call=1)
    state = init_pretext_state(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="every step or for none"):
        make_staged_train_step(cfg, steps_per_call=2)(state, torch.tensor(_bank(3)), [0, 1], _s_starts()[:2],
                                                      [None, torch.Generator()])


def test_restore_keeps_the_live_optimizer_capturable_flag(tmp_path):
    """A checkpoint written where Adam was capturable (a card) restores into
    the CPU's non-capturable Adam, which then steps."""
    from zeronotesamba_torch.train.checkpoint import CheckpointManager
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step

    cfg = PretextConfig(batch_size=B, crop_frames=CROP)
    state = init_pretext_state(cfg, 0, device="cpu")
    step = make_staged_train_step(cfg)
    state, *_ = step(state, torch.tensor(_bank(3)), 1, _s_starts()[0], None)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    path = tmp_path / "ckpt_0.pt"
    payload = torch.load(path, weights_only=True)
    for group in payload["optimizer"]["param_groups"]:
        group["capturable"] = True
    torch.save(payload, path)
    restored = mgr.restore(init_pretext_state(cfg, 1, device="cpu"))
    assert [g["capturable"] for g in restored.optimizer.param_groups] == [False]
    restored, loss, _, _ = step(restored, torch.tensor(_bank(3)), 2, _s_starts()[1], None)
    assert restored.step == 2 and np.isfinite(loss.item())
