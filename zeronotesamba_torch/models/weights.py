"""Carry weights into the port: JAX/Flax trees and reference state-dict files.

Key layout (the reference's Pretext_CNN state dict, loaded into
``FusedDownstream.pretext``):

- ``{anchor,postve}.pretrained.cv{1..8}.weight`` (cout, cin, kh, kw)
  <- Flax ``conv{i}.kernel`` (kh, kw, cin, cout)
- ``{anchor,postve}.pretrained.cv{1..8}.bias`` <- ``conv{i}.bias``
- ``{anchor,postve}.fc1.weight`` (1, 128, 1) <- ``head.proj.kernel`` (128, 1)
- ``{anchor,postve}.fc1.bias`` (1,) <- ``head.proj.bias``
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from zeronotesamba_torch.models.encoder import CONV_SPECS

STREAMS = ("anchor", "postve")


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
    """Flax FusedDownstream / TwinPretext params (numpy leaves) -> the port's
    ``FusedDownstream.pretext`` state dict in the reference key names."""
    p = params["params"] if "params" in params else params
    if "pretext" in p:
        p = p["pretext"]
    out: Dict[str, torch.Tensor] = {}
    for stream in STREAMS:
        out.update(_branch_from_jax(p[stream], f"{stream}."))
    return out


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
