"""Train state and optimizer factories (reference learning-rate rules).

Port of zeronotesamba_tpu/train/state.py. The reference's
loader.load_models policy (loader.py:8-69):

- status 'vanilla':                 Adam(lr)
- status 'pretrained' + finetune:   Adam(0.5 * lr * 10e-2) == 0.05*lr
- status 'pretrained' + frozen:     Adam(lr), both conv trunks frozen
- status 'clmr' + finetune:         Adam(0.5 * lr)
- status 'clmr' + frozen:           Adam(lr), conv trunk frozen

``torch.optim.Adam`` with betas (0.9, 0.999) and eps 1e-8 has optax.adam's
update rule. On a card it is ``capturable``: its step count and bias
correction stay on the device, so a CUDA graph can hold the update
(train/multistep.py), and the eager step runs the same update as the
graph. A frozen trunk is left out of the optimizer: its one param group
holds only the heads, so the trunk tensors never change. That stands
for the JAX package's optax.multi_transform + set_to_zero over every leaf
under an ``encoder``, and for the reference's requires_grad=False loop.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# The encoder trunk's module name in the reference layout (DS_CNN.pretrained).
TRUNK = "pretrained"


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps taken; on a
    card also the CUDA graphs of multi-step calls captured on this state
    (train/multistep.py)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    graphs: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)


def _adam(params, lr: float) -> torch.optim.Adam:
    params = list(params)
    capturable = any(p.is_cuda for p in params)
    return torch.optim.Adam(params, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS, capturable=capturable)


def downstream_learning_rate(status: str, pre: str, lr: float) -> float:
    if status == "pretrained" and pre != "frozen":
        return 0.5 * lr * 10e-2
    if status == "clmr" and pre != "frozen":
        return 0.5 * lr
    return lr


def make_optimizer(model: nn.Module, status: str, pre: str, lr: float) -> torch.optim.Adam:
    """Adam at the status/pre lr rule over every parameter, or with a frozen
    trunk over only those outside it (the heads)."""
    params = list(model.parameters())
    if pre == "frozen" and status in ("pretrained", "clmr"):
        params = [p for name, p in model.named_parameters() if TRUNK not in name.split(".")]
    return _adam(params, downstream_learning_rate(status, pre, lr))


def pretext_learning_rate(task: str = "zerons", lr: float | None = None) -> float:
    """Reference pretext optimizers' lr (pretext.py:202,208).

    ``lr=None`` = reference parity (zerons 1e-6, clmr 1e-5). The reference
    amortizes its tiny zerons lr over ~3e5 steps (20 chunks x 1440 tracks x
    10+ epochs, pretext.py:255-321); demo-scale runs (~1e2 steps) may pass an
    explicitly larger lr to reach an equivalent optimization distance.
    """
    if lr is None:
        lr = 1e-6 if task == "zerons" else 1e-5
    return lr


def pretext_optimizer(model: nn.Module, task: str = "zerons", lr: float | None = None) -> torch.optim.Adam:
    """Reference pretext optimizer (pretext.py:202,208): Adam over every
    parameter at ``pretext_learning_rate(task, lr)``."""
    return _adam(model.parameters(), pretext_learning_rate(task, lr))
