"""The port's learned separator against the JAX package's, on the CPU.

Tolerances: the MaskNet forward on transplanted params, masks within 1e-5;
one train_step from the same params and crops, the loss within 1e-5
relative, each gradient tensor within 1e-3 of its largest |g|, and the
parameters after Adam's first step within 2 lr plus float32 rounding (a
step moves a weight by about lr whatever its gradient, so the gradients are
the sharper check); ``si_sdr`` within 1e-5 relative; ``synth_bank`` bit for
bit; ``separate_learned`` and the ``learned`` backend on the shipped
weights (the committed npz in the port, the orbax checkpoint in JAX) within
1e-4 of the stem's peak.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training.train_state import TrainState as JTrainState

from zeronotesamba_tpu.data import separation as jseparation
from zeronotesamba_tpu.models.separator import MaskNet as JMaskNet
from zeronotesamba_tpu.train import separator as jsep
from zeronotesamba_tpu.train.checkpoint import load_params as j_load_params
from zeronotesamba_torch import cli
from zeronotesamba_torch.data import separation
from zeronotesamba_torch.models.separator import SEPARATOR_NPZ, MaskNet, load_separator
from zeronotesamba_torch.models.weights import separator_jax_from_state_dict, state_dict_from_jax
from zeronotesamba_torch.train import separator as sep

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CKPT = os.path.join(ROOT, "models", "separator")
LR = 1e-3


def _jax_params(seed: int) -> dict:
    p = JMaskNet().init(jax.random.PRNGKey(seed), jnp.zeros((1, sep.N_BINS, 32, 1)))
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def shipped():
    return j_load_params(JAX_CKPT), load_separator(device="cpu")


@pytest.fixture(scope="module")
def row():
    """One 4 s (mix, drums, rest) row."""
    return sep.synth_bank(1, 4.0, seed=11)[0]


def test_masknet_forward_equals_jax():
    params = _jax_params(0)
    x = np.random.default_rng(0).standard_normal((2, sep.N_BINS, 48)).astype(np.float32)
    ref = np.asarray(JMaskNet().apply(params, jnp.asarray(x[..., None])))  # (B, F, T, 2)
    model = MaskNet()
    model.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = model(torch.tensor(x)[:, None]).numpy()  # (B, 2, F, T)
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-6)


def test_state_dict_round_trips_through_the_flax_tree():
    params = _jax_params(1)
    back = separator_jax_from_state_dict(state_dict_from_jax(params))
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for (path, a), b in zip(flat, jax.tree.leaves(back)):
        assert np.array_equal(a, b), path


def test_init_draws_flax_default_distribution():
    model = MaskNet()
    model.reset_parameters(torch.Generator().manual_seed(0))
    w = model.convs[3].weight  # 48 x 48 x 3 x 3: fan_in 432
    assert torch.all(model.convs[3].bias == 0)
    assert abs(w.std().item() * np.sqrt(432) - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / np.sqrt(432) / 0.87962566103423978 + 1e-6


def test_train_step_equals_jax():
    """One step at batch 2 from the same params, bank and crop draws."""
    params = _jax_params(2)
    bank = sep.synth_bank(2, 4.5, seed=5)
    rng = np.random.default_rng(3)
    song = rng.integers(0, 2, size=2, dtype=np.int32)
    offs = rng.integers(0, bank.shape[-1] - sep.CROP_LEN + 1, size=2, dtype=np.int32)

    jstate = JTrainState.create(apply_fn=JMaskNet().apply, params=params, tx=optax.adam(LR))
    jbank, jsong, joffs = jnp.asarray(bank), jnp.asarray(song), jnp.asarray(offs)

    def jloss(p):  # the loss of jsep.train_step, for its gradients
        crops = jsep._crop(jbank, jsong, joffs)
        spec, logmag = jsep._features(crops[:, 0])
        mag = jnp.abs(spec[:, :sep.N_BINS])
        masks = JMaskNet().apply(p, logmag)
        return sum(jnp.mean(jnp.abs(mag * masks[..., k] - jnp.abs(jsep._stft(crops[:, 1 + k], sep.N_FFT, sep.HOP)
                                                                   [:, :sep.N_BINS]))) for k in (0, 1))

    jgrads = jax.tree.map(np.asarray, jax.grad(jloss)(params))
    jstate, jl = jsep.train_step(jstate, jbank, jsong, joffs)

    state = sep.init_separator_state(sep.SeparatorConfig(lr=LR), 0, params=params, device="cpu")
    state, loss = sep.train_step(state, torch.tensor(bank), torch.tensor(song).long(), torch.tensor(offs).long())
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))

    grads = {k: v.grad for k, v in state.model.named_parameters()}
    ref_grads = state_dict_from_jax(jgrads)
    after = state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    eps = torch.finfo(torch.float32).eps
    for k, p in state.model.named_parameters():
        g, rg = grads[k], ref_grads[k]
        assert (g - rg).abs().max() <= 1e-3 * rg.abs().max(), k
        excess = ((p.detach() - after[k]).abs() - 2 * LR - 2 * eps * after[k].abs()).max()
        assert excess <= 0, k
        assert (p.detach() - torch.as_tensor(state_dict_from_jax(params)[k])).abs().max() > 0.5 * LR, k


def test_si_sdr_equals_jax():
    rng = np.random.default_rng(4)
    ref = rng.standard_normal((3, 8000)).astype(np.float32)
    est = (0.7 * ref + 0.2 * rng.standard_normal((3, 8000))).astype(np.float32)
    got = sep.si_sdr(torch.tensor(est), torch.tensor(ref)).numpy()
    np.testing.assert_allclose(got, np.asarray(jsep.si_sdr(jnp.asarray(est), jnp.asarray(ref))), rtol=1e-5)
    assert sep.si_sdr(torch.tensor(0.3 * ref), torch.tensor(ref)).min() > 60.0


def test_synth_bank_equals_jax_bit_for_bit():
    a, b = sep.synth_bank(3, 2.0, seed=999), jsep.synth_bank(3, 2.0, seed=999)
    assert a.dtype == b.dtype and a.shape == b.shape == (3, 3, 32000)
    assert np.array_equal(a, b)


def test_separate_learned_on_the_shipped_weights_equals_jax(shipped, row):
    jparams, model = shipped
    got = sep.separate_learned(row[0], model)
    ref = jsep.separate_learned(row[0], jparams)
    for g, r in zip(got, ref):
        assert g.shape == r.shape == row[0].shape
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()


def test_learned_backend_order_and_cache(shipped, row, monkeypatch):
    """(anchor, positive) = (rest, drums) as in JAX; one MaskNet per (path,
    device); an orbax directory is refused with the exporter named."""
    monkeypatch.setattr(separation, "_LEARNED_MODEL_CACHE", {})
    drums, rest = sep.separate_learned(row[0], shipped[1])
    anchor, positive = separation.separate(row[0], 16000, "learned", model_path=SEPARATOR_NPZ, device="cpu")
    assert np.array_equal(anchor, rest) and np.array_equal(positive, drums)
    j_anchor, j_positive = jseparation.separate(row[0], 16000, "learned", model_path=JAX_CKPT)
    for g, r in ((anchor, j_anchor), (positive, j_positive)):
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()
    (model,) = separation._LEARNED_MODEL_CACHE.values()
    separation.separate(row[0][:8000], 16000, "learned", model_path=os.path.relpath(SEPARATOR_NPZ), device="cpu")
    assert list(separation._LEARNED_MODEL_CACHE.values()) == [model]
    with pytest.raises(ValueError, match="test_torch_separator_export"):
        separation.separate(row[0], 16000, "learned", model_path=JAX_CKPT, device="cpu")
    with pytest.raises(ValueError, match="requires model_path"):
        separation.separate(row[0], 16000, "learned", device="cpu")


def test_train_separator_saves_its_best_params(tmp_path, monkeypatch):
    """Two steps at batch 1 on 4.2 s songs; the npz it saves reloads equal
    to the params it returns, and evaluation ran at the last step."""
    ckpt = str(tmp_path / "sep.npz")
    cfg = sep.SeparatorConfig(steps=2, batch_size=1, lr=1e-3, eval_every=5, checkpoint_path=ckpt)
    best, hist = sep.train_separator(cfg, train_songs=2, val_songs=1, duration_s=4.2, device="cpu")
    assert [len(v) for v in hist.values()] == [1, 1, 1] and all(np.isfinite(v[0]) for v in hist.values())
    loaded = load_separator(ckpt, device="cpu").state_dict()
    assert set(loaded) == set(best) and all(torch.equal(loaded[k], best[k]) for k in best)
    with np.load(ckpt) as z:
        assert sorted(z.files) == sorted(f"params/Conv_{i}/{n}" for i in range(6) for n in ("kernel", "bias"))


def test_cli_train_separator_on_cpu(tmp_path, capsys):
    ckpt, out = str(tmp_path / "s.npz"), str(tmp_path / "report.json")
    cli.main(["train-separator", "--steps", "2", "--batch-size", "1", "--train-songs", "2", "--val-songs", "1",
              "--checkpoint", ckpt, "--out", out, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    with open(out) as fh:
        report = json.load(fh)
    assert set(printed) == {"learned_si_sdr_drums", "learned_si_sdr_rest", "hpss_si_sdr_drums", "hpss_si_sdr_rest"}
    assert {k: v for k, v in report.items() if k != "history"} == printed
    assert all(np.isfinite(v) for v in printed.values()) and len(report["history"]["loss"]) == 1
    assert os.path.isfile(ckpt) and not os.path.exists(os.path.join(ROOT, "models", "separator_torch.npz"))
