"""Carry weights into the port: JAX/Flax trees and reference state-dict files.

``state_dict_from_jax`` turns a Flax params tree (numpy leaves) into the
state dict of the port's model of the same class, in the reference's key
names (zeroNoteSamba/models/models.py):

- ``DSCNN`` tree (``encoder``, ``head``) -> ``DS_CNN`` keys
  ``pretrained.cv{1..8}.{weight,bias}``, ``fc1.{weight,bias}``;
- ``TwinPretext`` tree (``anchor``, ``postve``) -> ``Pretext_CNN`` keys, the
  DS_CNN keys under ``anchor.`` and ``postve.``;
- ``FusedDownstream`` tree (``pretext``) -> ``Down_CNN`` keys, the
  Pretext_CNN keys under ``pretext.``.

Per branch: ``pretrained.cv{i}.weight`` (cout, cin, kh, kw) <- Flax
``conv{i}.kernel`` (kh, kw, cin, cout); ``fc1.weight`` (1, 128, 1) <-
``head.proj.kernel`` (128, 1); biases as they are. A gradient tree has the
params' layout and converts the same way.

A ``BockTCN`` tree (``front1``.., ``tcn_d{d}``, ``head``) keeps its Flax
names (``bock_state_dict_from_jax``). A ``MaskNet`` tree (``Conv_0``..
``Conv_5``) maps onto ``convs.0``..``convs.5`` (``separator_state_dict_from_jax``).

A Beat This! state dict (CPJKU beat_this) keeps the source's names
(``frontend.stem.conv2d.weight``, ``transformer_blocks.layers.0.0.to_qkv.weight``,
...; ``load_beat_this_state_dict``): a published checkpoint's
``state_dict``, whose keys start ``model.`` (and ``_orig_mod.`` after
``torch.compile``), loads once those prefixes are cut.

A Flax tree on disk is an ``.npz`` of its leaves under their key paths
joined by ``/`` (``params/Conv_0/kernel``, ...), float32: what the exporter
in tests/test_torch_separator_export.py writes from an orbax checkpoint, and
``np.savez(path, **flatten_flax(tree))`` writes. ``load_state_dict_file``
reads such a file through ``state_dict_from_jax``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from zeronotesamba_torch.models.encoder import CONV_SPECS

STREAMS = ("anchor", "postve")
FUSED_PREFIX = "pretext."


def _branch_from_jax(branch: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    sd = {}
    for i in range(1, len(CONV_SPECS) + 1):
        conv = branch["encoder"][f"conv{i}"]
        sd[f"{prefix}pretrained.cv{i}.weight"] = np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"{prefix}pretrained.cv{i}.bias"] = np.asarray(conv["bias"], np.float32)
    proj = branch["head"]["proj"]
    sd[f"{prefix}fc1.weight"] = np.asarray(proj["kernel"], np.float32).T[:, :, None]
    sd[f"{prefix}fc1.bias"] = np.asarray(proj["bias"], np.float32)
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def bock_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax BockTCN params (numpy leaves, with or without the ``params``
    wrapper) -> the port BockTCN's state dict. Kernels: 2-D conv (kh, kw,
    in, out), kh the frequency axis -> (out, in, kh, kw); 1-D conv (k, in,
    out) -> (out, in, k); dense (in, out) -> (out, in)."""
    p = params["params"] if "params" in params else params
    order = {4: (3, 2, 0, 1), 3: (2, 1, 0), 2: (1, 0)}
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], prefix: str) -> None:
        for name, leaf in tree.items():
            if isinstance(leaf, Mapping):
                walk(leaf, f"{prefix}{name}.")
                continue
            a = np.asarray(leaf, np.float32)
            if name == "kernel":
                a = a.transpose(order[a.ndim])
            sd[prefix + {"kernel": "weight", "bias": "bias"}[name]] = torch.tensor(np.ascontiguousarray(a))

    walk(p, "")
    return sd


def separator_state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax MaskNet params (with or without the ``params`` wrapper) -> the
    port MaskNet's state dict: ``Conv_i.kernel`` (kh, kw, in, out) ->
    ``convs.i.weight`` (out, in, kh, kw), biases as they are."""
    p = params["params"] if "params" in params else params
    sd = {}
    for name, conv in p.items():
        i = int(name[len("Conv_"):])
        sd[f"convs.{i}.weight"] = np.asarray(conv["kernel"], np.float32).transpose(3, 2, 0, 1)
        sd[f"convs.{i}.bias"] = np.asarray(conv["bias"], np.float32)
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def separator_jax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``separator_state_dict_from_jax``: a MaskNet state
    dict -> its Flax params tree of numpy arrays, with the ``params`` wrapper."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in sd.items():
        _, i, leaf = key.split(".")
        a = v.detach().cpu().numpy().astype(np.float32)
        tree.setdefault(f"Conv_{i}", {})["kernel" if leaf == "weight" else "bias"] = (
            a.transpose(2, 3, 1, 0) if leaf == "weight" else a)
    return {"params": tree}


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax DSCNN / TwinPretext / FusedDownstream / BockTCN / MaskNet params
    (numpy leaves, with or without the ``params`` wrapper) -> the matching
    port model's state dict (module docstring)."""
    p = params["params"] if "params" in params else params
    if "Conv_0" in p:
        return separator_state_dict_from_jax(p)
    if "front1" in p:
        return bock_state_dict_from_jax(p)
    if "pretext" in p:
        return {FUSED_PREFIX + k: v for k, v in state_dict_from_jax(p["pretext"]).items()}
    if "encoder" in p:
        return _branch_from_jax(p, "")
    out: Dict[str, torch.Tensor] = {}
    for stream in STREAMS:
        out.update(_branch_from_jax(p[stream], f"{stream}."))
    return out


def load_weights(model: nn.Module, weights: Mapping[str, Any]) -> None:
    """Copy ``weights`` into ``model``'s own tensors.

    ``weights`` is a Flax params tree (converted by state_dict_from_jax) or a
    state dict: the model's own, or for a ``FusedDownstream`` the reference
    Pretext_CNN dict (``anchor.``/``postve.`` keys), which goes into
    ``model.pretext`` as the reference's loader puts it (loader.py:22-27).
    """
    if any(isinstance(v, Mapping) for v in weights.values()):
        weights = state_dict_from_jax(weights)
    sd = {k: torch.as_tensor(v) for k, v in weights.items()}
    if hasattr(model, "pretext") and not any(k.startswith(FUSED_PREFIX) for k in sd):
        model.pretext.load_state_dict(sd)
    else:
        model.load_state_dict(sd)


def reference_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's weights on the CPU in the reference checkpoint layout: a
    ``FusedDownstream`` as its Pretext_CNN dict (what reference ``.pth``
    files hold and ``infer --params`` loads), any other model as it is."""
    src = model.pretext if hasattr(model, "pretext") else model
    return {k: v.detach().cpu().clone() for k, v in src.state_dict().items()}


def flatten_flax(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested Flax tree -> {``a/b/leaf``: float32 array}."""
    flat: Dict[str, np.ndarray] = {}
    for name, leaf in tree.items():
        if isinstance(leaf, Mapping):
            flat.update(flatten_flax(leaf, f"{prefix}{name}/"))
        else:
            flat[prefix + name] = np.asarray(leaf, np.float32)
    return flat


def unflatten_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """{``a/b/leaf``: array} -> the nested Flax tree."""
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        *parents, name = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


BEAT_THIS_PREFIXES = ("model.", "_orig_mod.")


def load_beat_this_state_dict(weights: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A Beat This! state dict in the source's key names -> the port
    ``BeatThis``'s: a checkpoint's ``state_dict`` entry taken, the prefixes
    ``model.`` and ``_orig_mod.`` cut, the rotary embedding's stored
    frequencies checked against the port's and dropped (the port computes
    them), BatchNorm's ``num_batches_tracked`` added where missing."""
    from zeronotesamba_torch.models.beat_this import Rotary

    if "state_dict" in weights and isinstance(weights["state_dict"], Mapping):
        weights = weights["state_dict"]
    sd: Dict[str, torch.Tensor] = {}
    for key, value in weights.items():
        for prefix in BEAT_THIS_PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix):]
        sd[key] = torch.as_tensor(value)
    for key in [k for k in sd if k.endswith("rotary_embed.freqs")]:
        freqs = sd.pop(key).double()
        expected = Rotary(2 * freqs.numel()).inv_freq()
        if not torch.allclose(freqs, expected, rtol=1e-6, atol=0.0):
            raise ValueError(f"{key}: rotary frequencies differ from theta 10,000 over {2 * freqs.numel()} dims")
    for key in [k for k in sd if k.endswith(".running_var")]:
        sd.setdefault(key[: -len("running_var")] + "num_batches_tracked", torch.tensor(0))
    return sd


def load_beat_this_file(path: str) -> Dict[str, torch.Tensor]:
    """A Beat This! checkpoint (``.ckpt``, as published) -> the port
    ``BeatThis``'s state dict (``load_beat_this_state_dict``)."""
    if not path.endswith(".ckpt"):
        raise ValueError(f"{path}: expected a .ckpt Beat This! checkpoint")
    return load_beat_this_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` or ``.npz`` in the reference key names
    (``anchor.pretrained.cv1.weight``, ..., ``postve.fc1.bias``), or an
    ``.npz`` of a Flax tree (keys with ``/``), converted by
    ``state_dict_from_jax``."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            if any("/" in k for k in data.files):
                return state_dict_from_jax(unflatten_flax({k: data[k] for k in data.files}))
            return {k: torch.tensor(data[k]) for k in data.files}
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return {k: torch.as_tensor(v) for k, v in sd.items()}
    raise ValueError(f"{path}: expected a .pth or .npz state dict")
