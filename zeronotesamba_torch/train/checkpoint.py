"""Checkpoint/resume with torch.save (port of zeronotesamba_tpu/train/checkpoint.py).

The reference only ever saves best-validation state dicts and cannot resume
mid-run (its optimizer state is never saved). Here a checkpoint holds the
whole train state: the model's state dict, the optimizer's (Adam's moments
and step counts), the step and the caller's metrics, one file per step.
``save_params`` is the light "best params" slot, written in the reference
key names so it loads as it is into ``infer --params``.

The JAX package writes orbax directories, which the port does not read (it
imports no orbax). Their params trees go through the exporter in
tests/test_torch_separator_export.py (``export_params_npz``) into an
``.npz`` of ``/``-joined Flax key paths, which ``load_params`` reads and
converts (models/weights.state_dict_from_jax).
"""

from __future__ import annotations

import os
import re
from typing import Mapping, Optional

import numpy as np
import torch

from zeronotesamba_torch.models.weights import load_state_dict_file, reference_state_dict
from zeronotesamba_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """Numbered checkpoints ``ckpt_<step>.pt`` under ``directory``; the
    newest ``max_to_keep`` stay."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step}.pt")

    def _steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self._dir)) if m)

    def save(self, step: int, state: TrainState, *, metrics: Optional[Mapping[str, float]] = None):
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "metrics": {k: float(v) for k, v in (metrics or {}).items()},
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))  # a crash mid-write leaves no partial checkpoint
        for old in self._steps()[: -self._max_to_keep]:
            os.remove(self._path(old))

    def restore(self, state: TrainState, step: Optional[int] = None) -> TrainState:
        """Load checkpoint ``step`` (default: the latest) into ``state``'s
        model and optimizer, on their device, and return it. The optimizer's
        state tensors are new ones, so a multi-step call on ``state``
        captures its CUDA graph anew (train/multistep.py)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self._dir}")
        payload = torch.load(self._path(step), map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["model"])
        # Adam is capturable on a card and not on the CPU (train/state.py):
        # the live optimizer's choice holds whichever device saved the file.
        for saved, live in zip(payload["optimizer"]["param_groups"], state.optimizer.param_groups):
            saved["capturable"] = live.get("capturable", False)
        state.optimizer.load_state_dict(payload["optimizer"])
        state.step = payload["step"]
        return state

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self):
        """Nothing stays open between calls; kept for the JAX manager's interface."""


def save_params(path: str, model: torch.nn.Module):
    """One-shot best-params save in the reference key names: a ``.pth``
    (torch.save) or an ``.npz``, by the path's suffix."""
    sd = reference_state_dict(model)
    path = os.path.abspath(path)
    if path.endswith((".npz", ".pth")):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".npz"):
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    elif path.endswith(".pth"):
        torch.save(sd, path)
    else:
        raise ValueError(f"{path}: expected a .pth or .npz path")


def load_params(path: str) -> dict:
    """The state dict ``save_params`` wrote, or that of an exported Flax
    tree's ``.npz`` (models/weights.load_state_dict_file)."""
    return load_state_dict_file(os.path.abspath(path))
