"""The port's FusedDownstream against the JAX model, with weights carried
across by state_dict_from_jax. Float32, eval mode; tolerance 2e-5 on the
pulses, as tests/test_models.py holds the JAX model to its torch oracle."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.models.encoder import FusedDownstream as JFused
from zeronotesamba_torch.models.encoder import CONV_SPECS, DSCNN, Encoder, FusedDownstream
from zeronotesamba_torch.models.weights import state_dict_from_jax

torch.set_num_threads(2)

ATOL = 2e-5
B, T = 2, 64


@pytest.fixture(scope="module")
def jax_params():
    x = jnp.zeros((1, 96, T, 1))
    p = JFused().init(jax.random.PRNGKey(0), x, x)
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(42)
    # Log-VQT-like values around the standardization mean.
    return [(rng.standard_normal((B, 96, T)) * 4.0 - 6.0).astype(np.float32) for _ in range(2)]


def _port(params, **kw):
    model = FusedDownstream(**kw)
    model.load_state_dict(state_dict_from_jax(params))
    return model.eval()


def test_param_count_matches_jax(jax_params):
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(jax_params))
    assert sum(p.numel() for p in FusedDownstream().parameters()) == n_jax


@pytest.fixture(scope="module")
def jax_out(jax_params, inputs):
    """Every JAX output the tests compare, from one jitted program."""

    @jax.jit
    def run(params, a, p):
        anc, pos = JFused().apply(params, a, p, method=lambda m, x, y: m.pretext(x, y))
        la, lp = JFused().apply(params, a, p, method=lambda m, x, y: m.logits(x, y))
        emb = JFused().apply(params, a, method=lambda m, x: m.pretext.anchor.embed(x))  # (B, T, 128)
        return dict(anc=anc, pos=pos, la=la, lp=lp, emb=emb, max=JFused(reduction="max").apply(params, a, p),
                    mean=JFused(reduction="mean").apply(params, a, p))

    a, p = inputs
    return jax.tree_util.tree_map(np.asarray, run(jax_params, jnp.asarray(a)[..., None], jnp.asarray(p)[..., None]))


def test_streams_logits_and_embeddings_match_jax(jax_params, inputs, jax_out):
    model = _port(jax_params)
    a, p = (torch.tensor(x)[:, None] for x in inputs)
    with torch.no_grad():
        emb_a = model.pretext.anchor.embed(a)  # (B, 128, T)
        la, lp = model.logits(a, p)
    np.testing.assert_allclose(torch.sigmoid(la).numpy(), jax_out["anc"], atol=ATOL)
    np.testing.assert_allclose(torch.sigmoid(lp).numpy(), jax_out["pos"], atol=ATOL)
    np.testing.assert_allclose(la.numpy(), jax_out["la"], atol=1e-4)
    np.testing.assert_allclose(lp.numpy(), jax_out["lp"], atol=1e-4)
    np.testing.assert_allclose(emb_a.transpose(1, 2).numpy(), jax_out["emb"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("reduction", ["max", "mean"])
def test_fused_downstream_matches_jax(jax_params, inputs, jax_out, reduction):
    model = _port(jax_params, reduction=reduction)
    with torch.no_grad():
        fused = model(*(torch.tensor(x)[:, None] for x in inputs))
    assert fused.shape == (B, T) and fused.dtype == torch.float32
    np.testing.assert_allclose(fused.numpy(), jax_out[reduction], atol=ATOL)


def test_bf16_compute_tracks_f32(jax_params, inputs):
    """bfloat16 convs keep float32 parameters and return float32 pulses."""
    x = torch.tensor(inputs[0][:1, :, :32])[:, None]
    f32, bf16 = _port(jax_params), _port(jax_params, compute_dtype=torch.bfloat16)
    with torch.no_grad():
        ref = f32.pretext.anchor(x)
        out = bf16.pretext.anchor(x)
    assert out.dtype == torch.float32 and next(bf16.parameters()).dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=0.05)


def test_dropout_only_in_train_mode(jax_params, inputs):
    model = _port(jax_params)
    x = torch.tensor(inputs[0][:1, :, :32])[:, None]
    with torch.no_grad():
        assert torch.equal(model.pretext.anchor(x), model.pretext.anchor(x))
        model.train()
        torch.manual_seed(0)
        assert not torch.equal(model.pretext.anchor(x), model.eval().pretext.anchor(x))


@pytest.mark.parametrize("weight_init", ["he", "torch"])
def test_seeded_init_statistics(weight_init):
    enc = Encoder(weight_init=weight_init)
    enc.reset_parameters(torch.Generator().manual_seed(0))
    for i, (cout, (kh, kw)) in enumerate(CONV_SPECS):
        conv = getattr(enc, f"cv{i + 1}")
        fan_in = conv.weight[0].numel()
        w = conv.weight.detach()
        if weight_init == "he":
            assert w.abs().max() <= 2 * math.sqrt(2.0 / fan_in) / 0.87962566103423978 + 1e-6
            if w.numel() > 10000:
                assert abs(w.std().item() / math.sqrt(2.0 / fan_in) - 1) < 0.05
            assert not conv.bias.any()
        else:
            bound = 1 / math.sqrt(fan_in)
            assert w.abs().max() <= bound and conv.bias.abs().max() <= bound
    again = Encoder(weight_init=weight_init)
    again.reset_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(enc.state_dict().values(), again.state_dict().values()))


def test_reference_module_names():
    keys = set(DSCNN().state_dict())
    assert keys == {f"pretrained.cv{i}.{t}" for i in range(1, 9) for t in ("weight", "bias")} | {
        "fc1.weight", "fc1.bias"}
    assert DSCNN().fc1.weight.shape == (1, 128, 1)
