"""The two configurations' forward passes, plainly, from a weight dict.

Down_CNN (deezer/zeroNoteSamba ``models/models.py``): two independent
``_CNN`` trunks (``anchor``, ``postve``) of Conv2d layers over (96 bins,
frames) with SAME padding, max-pools over frequency only, ReLU then dropout
after every conv; a 1x1 Conv1d head to one logit a frame; fused by the
element-wise max of the two streams' logits (the max of their sigmoids).
BockTCN (after Davies & Boeck, EUSIPCO 2019): 3x3 convs with frequency
pools, ELU and dropout, then residual dilated 1-D conv blocks (ELU, dropout,
a 1x1 mix, ELU of the sum) and a dense head. Inputs are standardised by a
fixed ``(x - mean) / std``. Dropout keeps each cell with probability
``1 - rate`` and scales it by ``1 / (1 - rate)``; its mask is one
``torch.rand`` draw of the activation's shape from the generator, site by
site in forward order, as the configuration states it is drawn.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for the convs and matmuls inside (the control runs the
    reference with it on), restored after."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _dropout(h: torch.Tensor, rate: float, gen) -> torch.Tensor:
    if gen is None or rate == 0.0:
        return h
    keep = 1.0 - rate
    kept = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(kept, h / keep, torch.zeros((), dtype=h.dtype, device=h.device))


def _standardise(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return (x - cfg["input_mean"]) / cfg["input_std"]


def cnn_logits(w: dict, prefix: str, x: torch.Tensor, cfg: dict, gen=None) -> torch.Tensor:
    """One ``_CNN`` trunk and head: (B, 1, 96, T) -> (B, T) logits."""
    h = _standardise(x, cfg)
    pools = {int(k): v for k, v in cfg["pool_after"].items()}
    for i, (_, (kh, kw)) in enumerate(cfg["convs"]):
        h = F.conv2d(h, w[f"{prefix}pretrained.cv{i + 1}.weight"], w[f"{prefix}pretrained.cv{i + 1}.bias"],
                     padding=(kh // 2, kw // 2))
        if i in pools:
            h = F.max_pool2d(h, (pools[i], 1))
        h = _dropout(F.relu(h), cfg["dropout"], gen)
    return F.conv1d(h[:, :, 0], w[f"{prefix}fc1.weight"], w[f"{prefix}fc1.bias"])[:, 0]


def twin_logits(w: dict, x: torch.Tensor, cfg: dict, gen=None):
    """(B, 2, 96, T) -> the anchor's and the positive's logits, (B, T) each."""
    return (cnn_logits(w, "anchor.", x[:, 0:1], cfg, gen), cnn_logits(w, "postve.", x[:, 1:2], cfg, gen))


def tcn_logits(w: dict, x: torch.Tensor, cfg: dict, gen=None) -> torch.Tensor:
    """BockTCN: (B, 1, 96, T) -> (B, T) logits."""
    rate = cfg["dropout"]
    h = _standardise(x, cfg)
    for i, pool in enumerate(cfg["pools"]):
        h = F.conv2d(h, w[f"front{i + 1}.weight"], w[f"front{i + 1}.bias"], padding=cfg["front_kernel"] // 2)
        h = _dropout(F.elu(F.max_pool2d(h, (pool, 1))), rate, gen)
    h = h[:, :, 0]
    k = cfg["tcn_kernel"]
    for d in cfg["dilations"]:
        g = F.elu(F.conv1d(h, w[f"tcn_d{d}.dilated.weight"], w[f"tcn_d{d}.dilated.bias"], padding=(k - 1) // 2 * d,
                           dilation=d))
        g = _dropout(g, rate, gen)
        h = F.elu(h + F.conv1d(g, w[f"tcn_d{d}.mix.weight"], w[f"tcn_d{d}.mix.bias"]))
    return F.linear(h.transpose(1, 2), w["head.weight"], w["head.bias"])[..., 0]


def logits(w: dict, x: torch.Tensor, cfg: dict, gen=None) -> torch.Tensor:
    """The configuration's fused logits: (B, S, 96, T) -> (B, T)."""
    if cfg["model"] == "down_cnn":
        return torch.maximum(*twin_logits(w, x, cfg, gen))
    return tcn_logits(w, x[:, 0:1], cfg, gen)
