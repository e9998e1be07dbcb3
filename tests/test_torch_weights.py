"""Weights carried into the port: Flax tree -> state dict -> .pth/.npz files."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.models.encoder import FusedDownstream as JFused
from zeronotesamba_tpu.models.torch_compat import twin_params_to_torch
from zeronotesamba_torch.infer import BeatTracker
from zeronotesamba_torch.models.encoder import FusedDownstream
from zeronotesamba_torch.models.weights import load_state_dict_file, load_weights, state_dict_from_jax

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX model's parameter tree (structure and shapes from its init,
    traced without running), filled with seeded numpy values."""
    x = jnp.zeros((1, 96, 16, 1))
    shapes = jax.eval_shape(JFused().init, jax.random.PRNGKey(3), x, x)
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32), shapes)


def test_keys_and_values_match_torch_compat(jax_params):
    """A FusedDownstream tree becomes the whole model's state dict: the
    reference Pretext_CNN keys (torch_compat's) under ``pretext.``."""
    ours = state_dict_from_jax(jax_params)
    ref = twin_params_to_torch(jax_params)
    assert list(ours) == ["pretext." + k for k in ref]
    assert list(ours) == list(FusedDownstream().state_dict())
    for k, v in ref.items():
        assert tuple(ours["pretext." + k].shape) == v.shape, k
        np.testing.assert_array_equal(ours["pretext." + k].numpy(), v)
    # The TwinPretext tree inside it converts to the Pretext_CNN keys.
    inner = state_dict_from_jax(jax_params["params"]["pretext"])
    assert list(inner) == list(ref)
    assert all(torch.equal(inner[k], ours["pretext." + k]) for k in inner)


@pytest.fixture(scope="module")
def model():
    return FusedDownstream().eval()


def _forward(model, sd):
    load_weights(model, sd)
    x = torch.tensor(np.random.default_rng(0).standard_normal((1, 1, 96, 16)).astype(np.float32) * 4 - 6)
    with torch.no_grad():
        return model(x, x.flip(-1))


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_file_round_trip_gives_same_forward(jax_params, model, tmp_path, suffix):
    sd = state_dict_from_jax(jax_params)
    path = str(tmp_path / f"weights{suffix}")
    if suffix == ".pth":
        torch.save(sd, path)
    else:
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    loaded = load_state_dict_file(path)
    assert set(loaded) == set(sd)
    assert torch.equal(_forward(model, loaded), _forward(model, sd))


def test_load_rejects_other_formats(tmp_path):
    with pytest.raises(ValueError):
        load_state_dict_file(str(tmp_path / "weights.ckpt"))


def test_beat_tracker_accepts_tree_or_state_dict(jax_params):
    a = BeatTracker(jax_params, device="cpu").state_dict()
    b = BeatTracker(state_dict_from_jax(jax_params), device="cpu").state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
