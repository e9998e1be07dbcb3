"""The port's losses against the JAX package's: masked BCE in its three forms
and NT-Xent. Seeded numpy inputs go through both; values agree within 1e-6
relative. Gradients (torch autograd against jax.grad): BCE within 1e-5 of
the largest |g|, NT-Xent within 1e-5 absolute (its gradients go through the
norm clamp and cancel to about 1e-5 of their largest in float32).

At a logit of exactly 0 the two packages' BCE gradients differ by design:
JAX differentiates |z| at 0 as 1, so its softplus'(0) is 0; torch takes 0,
so the port's is 0.5 = sigmoid(0), the true derivative
(test_bce_gradient_at_a_zero_logit_is_sigmoid). The parity data hold no
zero logit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.losses import bce as jbce
from zeronotesamba_tpu.losses.ntxent import ntxent as j_ntxent
from zeronotesamba_torch.losses import bce
from zeronotesamba_torch.losses.ntxent import ntxent

torch.set_num_threads(2)

VALUE_RTOL = 1e-6
GRAD_TOL = 1e-5  # BCE: of the largest |g|; NT-Xent: absolute
B, T = 2, 64


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    la = (3.0 * rng.standard_normal((B, T))).astype(np.float32)
    lb = (la - 0.5 + rng.standard_normal((B, T))).astype(np.float32)
    target = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), size=(B, T), p=[0.8, 0.1, 0.1])
    mask = np.ones((B, T), np.float32)
    mask[1, 40:] = 0.0  # a padded tail
    return dict(la=la, lb=lb, target=target, mask=mask, prob=1.0 / (1.0 + np.exp(-la)))


# name -> (port function, JAX function, differentiated inputs, other inputs, kwargs)
CASES = {
    "bce_prob_masked": (bce.masked_bce, jbce.masked_bce, ("prob",), ("target", "mask"), {}),
    "bce_prob_unmasked": (bce.masked_bce, jbce.masked_bce, ("prob",), ("target",), {}),
    "bce_logits_masked": (bce.masked_bce_logits, jbce.masked_bce_logits, ("la",), ("target", "mask"), {}),
    "bce_logits_unmasked": (bce.masked_bce_logits, jbce.masked_bce_logits, ("la",), ("target",), {}),
    "bce_logits_pos_weight": (bce.masked_bce_logits, jbce.masked_bce_logits, ("la",), ("target", "mask"),
                              {"pos_weight": 8.0}),
    "bce_logits_pos_weight_0d": (bce.masked_bce_logits, jbce.masked_bce_logits, ("la",), ("target", "mask"),
                                 {"pos_weight": "0d"}),
    "twin_max": (bce.masked_bce_twin_logits, jbce.masked_bce_twin_logits, ("la", "lb"), ("target", "mask"),
                 {"reduction": "max"}),
    "twin_max_pos_weight": (bce.masked_bce_twin_logits, jbce.masked_bce_twin_logits, ("la", "lb"),
                            ("target", "mask"), {"reduction": "max", "pos_weight": 4.0}),
    "twin_mean": (bce.masked_bce_twin_logits, jbce.masked_bce_twin_logits, ("la", "lb"), ("target", "mask"),
                  {"reduction": "mean"}),
    "twin_mean_pos_weight_0d": (bce.masked_bce_twin_logits, jbce.masked_bce_twin_logits, ("la", "lb"),
                                ("target", "mask"), {"reduction": "mean", "pos_weight": "0d"}),
}


def _kwargs(kw, as_tensor):
    out = dict(kw)
    if out.get("pos_weight") == "0d":  # a 0-d tensor / array weight
        out["pos_weight"] = as_tensor(np.float32(3.0))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_bce_value_and_grad_match_jax(data, case):
    fn, jfn, diff, other, kw = CASES[case]
    xs = [torch.tensor(data[k], requires_grad=True) for k in diff]
    loss = fn(*xs, *(torch.tensor(data[k]) for k in other), **_kwargs(kw, torch.tensor))
    loss.backward()

    def jloss(*d):
        return jfn(*d, *(jnp.asarray(data[k]) for k in other), **_kwargs(kw, jnp.asarray))

    jval, jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(diff))))(*(jnp.asarray(data[k]) for k in diff))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(jval), rtol=VALUE_RTOL)
    for x, jg in zip(xs, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(x.grad.numpy(), jg, rtol=0, atol=GRAD_TOL * np.abs(jg).max())


def test_twin_max_is_logits_bce_of_the_max(data):
    la, lb, t, m = (torch.tensor(data[k]) for k in ("la", "lb", "target", "mask"))
    np.testing.assert_allclose(bce.masked_bce_twin_logits(la, lb, t, m, pos_weight=2.0).item(),
                               bce.masked_bce_logits(torch.maximum(la, lb), t, m, 2.0).item(), rtol=VALUE_RTOL)
    # l = 0, t = 1: the loss is w * log 2 exactly.
    got = bce.masked_bce_logits(torch.zeros(1, 1), torch.ones(1, 1), None, 8.0).item()
    np.testing.assert_allclose(got, 8.0 * np.log(2.0), rtol=VALUE_RTOL)


def test_bce_gradient_at_a_zero_logit_is_sigmoid():
    l = torch.zeros(1, 4, requires_grad=True)
    t = torch.tensor([[0.0, 1.0, 0.5, 0.0]])
    bce.masked_bce_logits(l, t).backward()
    np.testing.assert_allclose(l.grad.numpy(), (0.5 - t.numpy()) / 4, rtol=VALUE_RTOL)


def test_empty_mask_gives_zero_not_nan(data):
    la, t = torch.tensor(data["la"]), torch.tensor(data["target"])
    assert bce.masked_bce_logits(la, t, torch.zeros_like(la)).item() == 0.0


@pytest.mark.parametrize("b,d,temperature", [(4, 128, 0.25), (8, 16, 0.1), (2, 3, 1.0)])
def test_ntxent_value_and_grad_match_jax(b, d, temperature):
    rng = np.random.default_rng(b * 100 + d)
    a = rng.standard_normal((b, d)).astype(np.float32)
    p = (a + 0.5 * rng.standard_normal((b, d))).astype(np.float32)
    ta, tp = torch.tensor(a, requires_grad=True), torch.tensor(p, requires_grad=True)
    loss, pos, neg = ntxent(ta, tp, temperature)
    loss.backward()
    jout = j_ntxent(jnp.asarray(a), jnp.asarray(p), temperature)
    for got, ref in zip((loss, pos, neg), jout):
        np.testing.assert_allclose(got.item(), float(ref), rtol=VALUE_RTOL, atol=1e-7)
    jga, jgp = jax.grad(lambda x, y: j_ntxent(x, y, temperature)[0], argnums=(0, 1))(jnp.asarray(a), jnp.asarray(p))
    for g, jg in ((ta.grad, jga), (tp.grad, jgp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=GRAD_TOL)


def test_ntxent_denominator_includes_the_positive():
    """Asymmetric: loss_i = -log softmax_j(s_ij)[i] over the positives only,
    j = i included; identical unit rows give log(B) exactly."""
    x = torch.ones(4, 8)
    loss, pos, neg = ntxent(x, x, 0.25)
    np.testing.assert_allclose(loss.item(), np.log(4.0), rtol=VALUE_RTOL)
    assert pos.item() == pytest.approx(1.0) and neg.item() == pytest.approx(1.0)
