"""The port's BockTCN baseline against the JAX package's: the forward pass on
transplanted parameters, one ``status="bock"`` train step, and the ``beat``
CLI with ``--status bock``.

Tolerances: eval-mode logits, probabilities and embedding 2e-5; one train
step at dropout off from the same weights as in tests/test_torch_train.py:
loss 1e-5 relative, outputs 2e-5, gradients per tensor within 1e-4 of that
tensor's largest |g|, new parameters within 2 lr. The gradients hold while
both packages route every frequency max-pool window's gradient to the same
input; the draw here (data seed 21, init key 6) has no window whose two
largest inputs lie within float32 rounding of each other.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.data.datasets import SongRecord as JSongRecord
from zeronotesamba_tpu.models.baseline import TCN_DILATIONS as J_DILATIONS
from zeronotesamba_tpu.models.baseline import BockTCN as JBockTCN
from zeronotesamba_tpu.train import supervised as jsup
from zeronotesamba_torch import cli
from zeronotesamba_torch.data.datasets import build_synthetic
from zeronotesamba_torch.data.pulse import beat_pulse
from zeronotesamba_torch.models.baseline import TCN_DILATIONS, BockTCN
from zeronotesamba_torch.models.weights import bock_state_dict_from_jax, load_weights, state_dict_from_jax
from zeronotesamba_torch.train.supervised import (
    SupervisedConfig,
    dropout_generator,
    eval_step,
    init_state,
    train_step,
)

torch.set_num_threads(2)

B, T = 2, 96
LR = 1e-3


@pytest.fixture(scope="module")
def flax_params():
    x = jnp.zeros((1, 96, T, 1))
    return jax.tree_util.tree_map(np.asarray, jax.jit(JBockTCN().init)(jax.random.PRNGKey(6), x))


@pytest.fixture(scope="module")
def vqt():
    return (np.random.default_rng(21).standard_normal((B, 96, T)) * 4.0 - 6.0).astype(np.float32)


def test_transplant_names_and_layouts(flax_params):
    sd = bock_state_dict_from_jax(flax_params)
    model = BockTCN()
    assert set(sd) == set(model.state_dict())
    assert all(sd[k].shape == v.shape for k, v in model.state_dict().items())
    p = flax_params["params"]
    np.testing.assert_array_equal(sd["front2.weight"].numpy(), p["front2"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["tcn_d8.dilated.weight"].numpy(),
                                  p["tcn_d8"]["dilated"]["kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(sd["head.weight"].numpy(), p["head"]["kernel"].T)
    assert state_dict_from_jax(flax_params).keys() == sd.keys()
    assert tuple(TCN_DILATIONS) == tuple(J_DILATIONS)
    assert 1 + sum(4 * d for d in TCN_DILATIONS) > 68  # covers a 55 bpm beat period at 62.5 fps


@pytest.mark.parametrize("method", ["logits", "__call__", "embed"])
def test_forward_matches_flax(flax_params, vqt, method):
    model = BockTCN()
    load_weights(model, flax_params)
    model.eval()
    x = torch.tensor(vqt[:, None])
    with torch.no_grad():
        ours = {"logits": model.logits, "__call__": model, "embed": model.embed}[method](x).numpy()
    ref = np.asarray(JBockTCN().apply(flax_params, jnp.asarray(vqt[..., None]), method=method))
    if method == "embed":
        ours = ours.transpose(0, 2, 1)  # (B, C, T) -> the JAX (B, T, C)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)


def test_init_is_flax_default_and_seeded():
    a, b, c = BockTCN(), BockTCN(), BockTCN()
    for m, seed in ((a, 0), (b, 0), (c, 1)):
        m.reset_parameters(torch.Generator().manual_seed(seed))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa) and not torch.equal(sa["front1.weight"], sc["front1.weight"])
    assert all(not v.any() for k, v in sa.items() if k.endswith("bias"))
    w = sa["tcn_d1.dilated.weight"]  # lecun_normal: variance 1 / fan_in
    assert abs(w.std().item() - (1 / 80) ** 0.5) < 0.1 * (1 / 80) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 80) ** 0.5 / 0.87962566103423978 + 1e-6


def test_dropout_draws_from_the_given_generator(vqt):
    model = BockTCN().train()
    x = torch.tensor(vqt[:, None])
    outs = [model.logits(x, torch.Generator().manual_seed(s)).detach() for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    with pytest.raises(ValueError):
        model(x[:, 0])


def _example(t):
    return JSongRecord("x", np.zeros((1, 96, t), np.float32), np.zeros(t, np.float32), np.zeros(t, np.float32),
                       np.zeros(1), np.zeros(0))


@pytest.fixture(scope="module")
def step_inputs(vqt):
    rng = np.random.default_rng(22)
    pulse = np.stack([beat_pulse(np.sort(rng.uniform(0, T / 62.5, 3)), T) for _ in range(B)])
    mask = np.ones((B, T), np.float32)
    mask[1, 70:] = 0.0
    pulse[1, 70:] = 0.0
    return vqt[:, None], pulse, mask


@pytest.fixture(scope="module")
def jax_step(step_inputs):
    cfg = jsup.SupervisedConfig(status="bock", lr=LR, bucket_frames=T)
    state = jsup.init_state(cfg, _example(T), jax.random.PRNGKey(6))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    vqt, pulse, mask = (jnp.asarray(x) for x in step_inputs)

    def loss_fn(p):
        return jsup._loss_and_out(state.apply_fn, p, vqt, pulse, mask, None, "bock", 1.0)[0]

    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
    new_state, loss, out = jsup.train_step(state, vqt, pulse, mask, None, "bock")
    return dict(params=params, grads=grads, loss=float(loss), out=np.asarray(out),
                new_params=jax.tree_util.tree_map(np.asarray, new_state.params))


def test_bock_train_step_matches_jax(jax_step, step_inputs):
    state = init_state(SupervisedConfig(status="bock", lr=LR, bucket_frames=T), None, 0,
                       params=jax_step["params"], device="cpu")
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    state, loss, out = train_step(state, *(torch.tensor(x) for x in step_inputs), None, "bock")
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), jax_step["out"], rtol=0, atol=2e-5)
    ref_grads = bock_state_dict_from_jax(jax_step["grads"])
    new = bock_state_dict_from_jax(jax_step["new_params"])
    for name, p in state.model.named_parameters():
        g_ref = ref_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g_ref.numpy(), rtol=0, atol=1e-4 * g_ref.abs().max().item(),
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), rtol=0, atol=2 * LR, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"
    loss2, out2 = eval_step(state, *(torch.tensor(x) for x in step_inputs), "bock")
    assert np.isfinite(loss2.item()) and out2.shape == (B, T)


def test_bock_steps_lower_the_loss(step_inputs):
    """Twenty dropout-on Adam steps on one batch at lr 1e-3 fit it."""
    state = init_state(SupervisedConfig(status="bock", lr=LR), None, 1, device="cpu")
    x = [torch.tensor(a) for a in step_inputs]
    losses = [train_step(state, *x, dropout_generator(0, i, "cpu"), "bock")[1].item() for i in range(20)]
    assert losses[-1] < 0.7 * losses[0], losses


def test_cli_beat_status_bock_on_cpu(tmp_path):
    data, out = str(tmp_path / "d"), str(tmp_path / "beat.json")
    build_synthetic(n_songs=4, duration_s=1.0, seed=2, two_stream=False, device="cpu").save(data)
    cli.main(["beat", "--data", data, "--status", "bock", "--folds", "2", "--max-epochs", "1", "--batch-size", "2",
              "--lr", "1e-3", "--eval", "librosa", "--device", "cpu", "--out", out])
    with open(out) as fh:
        res = json.load(fh)
    assert np.isfinite(res["F1"]) and "InfoGain_std" in res
