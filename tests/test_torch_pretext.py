"""The port's pretext engine against the JAX package's: shift sampling, the
staged NT-Xent train step, the eval step and two epochs of the driver, from
transplanted JAX weights at dropout 0, on the full-width model at the JAX
tests' sizes (batch 4, crops of 32 frames, bank items of 64).

Tolerances:
- shifts, crops and fixed validation crops: exact;
- one staged step (zerons k = 1, zerons k = 2, clmr): loss and pos/neg
  cosines 1e-5 relative; gradients per tensor within 1e-3 of that tensor's
  largest |g|; parameters after Adam within 2 lr (Adam's first step moves a
  weight by at most lr) plus their float32 rounding (2 eps |p|);
- the eval step: 1e-5 relative; a step's loss and cosines equal the mean
  of its tracks' own NT-Xent values (k = 2: two tracks) at 1e-5 relative;
- the driver, 2 epochs: per-epoch losses and cosines 1e-3 relative, equal
  restarts, best parameters within 2 lr per update taken plus float32
  rounding (each Adam step moves a weight by at most lr on either side).

On these crops the pulses sit near a constant, so the loss is pinned near
ln(B) and the gradients are small. The gradient tolerance holds while both
packages route every max-pool window's gradient to the same input; a window
whose two largest inputs lie within float32 rounding may route it to the
other one, which moves every gradient below that pool (tests/test_torch_train.py).
Of four (bank seed, init key) draws tried on the zerons k = 1 step, two
had such a flip (up to 6.2e-2 of a tensor's largest |g|, in the convs below
a pool); the draw here (bank seed 0, init key 1) has none in any of the
three cases, which agree to 2.3e-5 of the largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zeronotesamba_tpu.experiments import pretext_driver as jdrv
from zeronotesamba_tpu.train import pretext as jpre
from zeronotesamba_tpu.train.state import TrainState as JTrainState
from zeronotesamba_torch.experiments import pretext_driver as pdrv
from zeronotesamba_torch.models.weights import state_dict_from_jax
from zeronotesamba_torch.train.pretext import (
    PretextConfig,
    crop_shifts,
    init_pretext_state,
    make_eval_step,
    make_staged_train_step,
    resolve_dtype,
    sample_shifts,
    staged_crops,
)

torch.set_num_threads(2)

B, CROP, FRAMES = 4, 32, 64
LR = 1e-4
BANK_SEED = 0
INIT_KEY = 1
EPS = float(np.finfo(np.float32).eps)


def _bank(n, seed=BANK_SEED):
    return (np.random.default_rng(seed).standard_normal((n, 2, 96, FRAMES)) * 4.0 - 6.0).astype(np.float32)


@pytest.mark.parametrize("frames,batch,crop", [(64, 4, 32), (626, 16, 313), (10, 8, 8)])
def test_shifts_and_crops_equal_jax(frames, batch, crop):
    for seed in (0, 7):
        ours, ref = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(sample_shifts(frames, batch, crop, ours),
                                      jpre.sample_shifts(frames, batch, crop, ref))
        item = np.random.default_rng(seed).standard_normal((2, 96, frames)).astype(np.float32)
        np.testing.assert_array_equal(crop_shifts(item, batch, crop, ours), jpre.crop_shifts(item, batch, crop, ref))
        assert ours.random() == ref.random()
    bank = np.random.default_rng(2).standard_normal((2, 2, 96, frames)).astype(np.float32)
    cfg = PretextConfig(batch_size=batch, crop_frames=crop)
    np.testing.assert_array_equal(pdrv.fixed_val_shifts(bank, cfg, 5),
                                  jdrv.fixed_val_shifts(bank, jpre.PretextConfig(batch_size=batch, crop_frames=crop), 5))


def test_staged_crops_gather_the_slices():
    bank = _bank(3)
    starts = np.array([[0, 5, 32, 17], [3, 3, 30, 40]])
    got = staged_crops(torch.tensor(bank), torch.tensor([2, 0]), torch.tensor(starts), CROP).numpy()
    for i, t in enumerate((2, 0)):
        for b, s in enumerate(starts[i]):
            np.testing.assert_array_equal(got[i, b], bank[t, :, :, min(s, FRAMES - CROP): min(s, FRAMES - CROP) + CROP])
    assert resolve_dtype("bf16") == torch.bfloat16
    with pytest.raises(ValueError):
        resolve_dtype("fp8")


@pytest.fixture(scope="module")
def jax_twin():
    """The JAX TwinPretext's initial params (numpy), dropout 0."""
    cfg = jpre.PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0, lr=LR)
    state = jpre.init_pretext_state(cfg, jax.random.PRNGKey(INIT_KEY))
    return jax.tree_util.tree_map(np.asarray, state.params)


def _jax_params(twin, task):
    return twin if task == "zerons" else {"params": twin["params"]["anchor"]}


def _record_grads():
    """An optax stage that keeps the gradients it is given as its state."""
    return optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))


def _step_inputs(k):
    rng = np.random.default_rng(11)
    starts = np.stack([sample_shifts(FRAMES, B, CROP, rng) for _ in range(k)])
    tracks = np.array([1]) if k == 1 else np.array([0, 2])
    return tracks, starts


CASES = [("zerons", 1), ("zerons", 2), ("clmr", 1)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{t}-k{k}" for t, k in CASES])
def jax_step(request, jax_twin):
    """One JAX make_staged_train_step at dropout 0: its loss and cosines, the
    gradients it applied and the parameters after Adam, as numpy."""
    task, k = request.param
    params = _jax_params(jax_twin, task)
    model = jpre.make_pretext_model(task, 0.0)
    tx = optax.chain(_record_grads(), optax.adam(LR, b1=0.9, b2=0.999))
    state = JTrainState.create(apply_fn=model.apply, params=params, tx=tx)
    step = jpre.make_staged_train_step(jpre.PretextConfig(task=task, batch_size=B, crop_frames=CROP,
                                                          dropout_rate=0.0, lr=LR))
    tracks, starts = _step_inputs(k)
    idx = jnp.int32(tracks[0]) if k == 1 else jnp.asarray(tracks, jnp.int32)
    st = jnp.asarray(starts[0] if k == 1 else starts, jnp.int32)
    new, loss, pc, nc = step(state, jnp.asarray(_bank(3)), idx, st, jax.random.key(0))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(task=task, k=k, params=params, loss=float(loss), pc=float(pc), nc=float(nc),
                grads=to_np(new.opt_state[0]), new_params=to_np(new.params))


def _port_state(task, params):
    return init_pretext_state(PretextConfig(task=task, batch_size=B, crop_frames=CROP, dropout_rate=0.0, lr=LR), 0,
                              params=params, device="cpu")


def test_staged_step_matches_jax(jax_step):
    task, k = jax_step["task"], jax_step["k"]
    state = _port_state(task, jax_step["params"])
    start = state_dict_from_jax(jax_step["params"])
    assert all(torch.equal(v, start[n]) for n, v in state.model.state_dict().items())
    tracks, starts = _step_inputs(k)
    cfg = PretextConfig(task=task, batch_size=B, crop_frames=CROP, lr=LR)
    bank = torch.tensor(_bank(3))
    # Each track's own NT-Xent before the step: the k = 2 step's loss and
    # cosines are their mean (the JAX package's tests/test_train.py::
    # test_pretext_multi_track_accumulation_matches_mean_of_singles).
    singles = [[v.item() for v in make_eval_step(cfg)(state, staged_crops(bank, torch.tensor([t]),
                                                                          torch.tensor(st[None]), CROP)[0])]
               for t, st in zip(tracks, starts)]
    args = (int(tracks[0]), starts[0]) if k == 1 else (tracks, starts)
    state, loss, pc, nc = make_staged_train_step(cfg)(state, bank, *args, None)
    assert state.step == 1
    np.testing.assert_allclose([loss.item(), pc.item(), nc.item()], np.mean(singles, axis=0), rtol=1e-5)
    for got, key in ((loss, "loss"), (pc, "pc"), (nc, "nc")):
        np.testing.assert_allclose(got.item(), jax_step[key], rtol=1e-5, err_msg=key)
    ref_grads = state_dict_from_jax(jax_step["grads"])
    new = state_dict_from_jax(jax_step["new_params"])
    for name, p in state.model.named_parameters():
        g_ref = ref_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g_ref.numpy(), rtol=0, atol=1e-3 * g_ref.abs().max().item(),
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), rtol=2 * EPS, atol=2 * LR, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"


@pytest.mark.parametrize("task", ["zerons", "clmr"])
def test_eval_step_matches_jax(jax_twin, task):
    params = _jax_params(jax_twin, task)
    batch = _bank(5)[:, :, :, :CROP]
    jcfg = jpre.PretextConfig(task=task, batch_size=5, crop_frames=CROP, dropout_rate=0.0)
    model = jpre.make_pretext_model(task, 0.0)
    jstate = JTrainState.create(apply_fn=model.apply, params=params, tx=optax.adam(LR))
    ref = jpre.make_eval_step(jcfg)(jstate, jnp.asarray(batch))
    got = make_eval_step(PretextConfig(task=task, batch_size=5, crop_frames=CROP))(_port_state(task, params),
                                                                                 torch.tensor(batch))
    np.testing.assert_allclose([g.item() for g in got], [float(r) for r in ref], rtol=1e-5)


def test_train_pretext_matches_jax(monkeypatch):
    """Two epochs of both drivers on the same 6-track bank (4 train, 2 val),
    same seed, dropout 0, the same initial weights: the JAX initializer is
    wrapped to run at dropout 0 and keep its params, and the port's to load
    them."""
    bank = _bank(6, seed=1)
    kw = dict(task="zerons", num_epochs=2, batch_size=B, crop_frames=CROP, lr=LR, seed=0)
    start = {}
    j_init, p_init = jdrv.init_pretext_state, pdrv.init_pretext_state

    def jax_init(pcfg, rng):
        state = j_init(dataclasses.replace(pcfg, dropout_rate=0.0), rng)
        start["params"] = jax.tree_util.tree_map(np.asarray, state.params)
        return state

    def port_init(pcfg, seed, **kwargs):
        return p_init(dataclasses.replace(pcfg, dropout_rate=0.0), seed, params=start["params"], **kwargs)

    monkeypatch.setattr(jdrv, "init_pretext_state", jax_init)
    monkeypatch.setattr(pdrv, "init_pretext_state", port_init)
    j_best, j_hist = jdrv.train_pretext(bank[2:], bank[:2], jdrv.PretextRunConfig(**kw))
    p_best, p_hist = pdrv.train_pretext(bank[2:], bank[:2], pdrv.PretextRunConfig(**kw), device="cpu")
    for key in ("train_loss", "val_loss", "train_pos", "train_neg", "val_pos", "val_neg"):
        assert len(p_hist[key]) == 2
        np.testing.assert_allclose(p_hist[key], j_hist[key], rtol=1e-3, err_msg=key)
    assert p_hist["restarts"] == j_hist["restarts"] == []
    updates = 2 * 4
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, j_best))
    assert set(p_best) == set(ref)
    for name, v in p_best.items():
        np.testing.assert_allclose(v.numpy(), ref[name].numpy(), rtol=2 * updates * EPS, atol=2 * LR * updates,
                                   err_msg=name)
