"""The orbax -> npz exporter, and the weights it writes read by the port.

``export_params_npz`` reads any orbax params tree with the JAX package's
``train/checkpoint.load_params`` and writes its leaves verbatim (float32,
key paths joined by ``/``) to an ``.npz``: the only form the PyTorch port
reads, since it imports no orbax. Regenerate the shipped separator with

    JAX_PLATFORMS=cpu python tests/test_torch_separator_export.py \\
        models/separator zeronotesamba_torch/assets/separator.npz

Tolerances: the exported arrays equal the committed ones bit for bit (a
zip's timestamps differ between two writes, so the arrays are compared, not
the files); the pulses of an exported FusedDownstream tree in the port
against the JAX model's within 1e-4, as tests/test_torch_infer.py holds
them.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def export_params_npz(src_dir: str, dst_npz: str) -> dict:
    """Orbax params tree at ``src_dir`` -> ``dst_npz``; returns the flat
    {key path: array} it wrote."""
    import jax

    from zeronotesamba_tpu.train.checkpoint import load_params

    tree = load_params(os.path.abspath(src_dir))
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    os.makedirs(os.path.dirname(os.path.abspath(dst_npz)), exist_ok=True)
    np.savez(dst_npz, **flat)
    return flat


def test_exporter_rerun_equals_the_committed_npz(tmp_path):
    from zeronotesamba_torch.models.separator import SEPARATOR_NPZ

    flat = export_params_npz(os.path.join(ROOT, "models", "separator"), str(tmp_path / "sep.npz"))
    assert len(flat) == 12 and sum(a.size for a in flat.values()) == 50690
    with np.load(str(tmp_path / "sep.npz")) as new, np.load(SEPARATOR_NPZ) as committed:
        assert sorted(new.files) == sorted(committed.files) == sorted(flat)
        for k in committed.files:
            a, b = new[k], committed[k]
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape and a.tobytes() == b.tobytes(), k


def test_exported_encoder_tree_loads_into_the_port(tmp_path):
    """A JAX FusedDownstream tree saved with orbax, exported, and read by the
    port's train/checkpoint.load_params gives the JAX model's pulses."""
    import jax

    from zeronotesamba_tpu.infer import BeatTracker as JBeatTracker
    from zeronotesamba_tpu.train.checkpoint import save_params as j_save_params
    from zeronotesamba_torch.data.synthetic import click_track
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.train.checkpoint import load_params

    jax_tracker = JBeatTracker(seed=3)
    j_save_params(str(tmp_path / "orbax"), jax.tree.map(np.asarray, jax_tracker.params))
    flat = export_params_npz(str(tmp_path / "orbax"), str(tmp_path / "fused.npz"))
    assert all(k.startswith("params/pretext/") for k in flat)
    tracker = BeatTracker(load_params(str(tmp_path / "fused.npz")), device="cpu")
    sig = click_track(3.0, 120.0, seed=4)[0]
    got = tracker.track_signal(sig, separation="mix", decoder=None)
    ref = jax_tracker.track_signal(sig, separation="mix", decoder=None)
    for name in ("anchor_pulse", "positive_pulse", "fused_pulse"):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name), atol=1e-4, err_msg=name)


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(f"usage: {sys.argv[0]} ORBAX_DIR OUT.npz")
    sys.path.insert(0, ROOT)
    out = export_params_npz(sys.argv[1], sys.argv[2])
    print(f"wrote {len(out)} arrays ({sum(a.size for a in out.values())} float32) to {sys.argv[2]}")
