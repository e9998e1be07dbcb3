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


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax DSCNN / TwinPretext / FusedDownstream params (numpy leaves, with
    or without the ``params`` wrapper) -> the matching port model's state
    dict in the reference key names (module docstring)."""
    p = params["params"] if "params" in params else params
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


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pth`` or ``.npz`` in the reference key names
    (``anchor.pretrained.cv1.weight``, ..., ``postve.fc1.bias``)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            return {k: torch.tensor(data[k]) for k in data.files}
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        return {k: torch.as_tensor(v) for k, v in sd.items()}
    raise ValueError(f"{path}: expected a .pth or .npz state dict")
