"""Seeded weights for a configuration, made on the device in a few large draws.

The benchmark makes the weights and hands the same tensors to the program
and to the reference. Conv and dense kernels are normal with the
configuration's fan-in scale (He: 2 / fan_in, LeCun: 1 / fan_in), biases
zero; the Down_CNN head (a torch Conv1d) is uniform in +-1/sqrt(fan_in),
its bias too. Keys are the program's state-dict names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def shapes(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(key, shape, init) of every leaf: init is "normal", "zero" or "uniform"."""
    out = []
    if cfg["model"] == "down_cnn":
        for stream in ("anchor", "postve"):
            cin = 1
            for i, (cout, (kh, kw)) in enumerate(cfg["convs"]):
                out += [(f"{stream}.pretrained.cv{i + 1}.weight", (cout, cin, kh, kw), "normal"),
                        (f"{stream}.pretrained.cv{i + 1}.bias", (cout,), "zero")]
                cin = cout
            out += [(f"{stream}.fc1.weight", (1, cfg["embed_dim"], 1), "uniform"),
                    (f"{stream}.fc1.bias", (1,), "uniform")]
        return out
    c, cin = cfg["channels"], 1
    for i in range(len(cfg["pools"])):
        k = cfg["front_kernel"]
        out += [(f"front{i + 1}.weight", (c, cin, k, k), "normal"), (f"front{i + 1}.bias", (c,), "zero")]
        cin = c
    for d in cfg["dilations"]:
        out += [(f"tcn_d{d}.dilated.weight", (c, c, cfg["tcn_kernel"]), "normal"),
                (f"tcn_d{d}.dilated.bias", (c,), "zero"),
                (f"tcn_d{d}.mix.weight", (c, c, 1), "normal"), (f"tcn_d{d}.mix.bias", (c,), "zero")]
    return out + [("head.weight", (1, c), "normal"), ("head.bias", (1,), "zero")]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed``, float32 on ``device``."""
    leaves = shapes(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    sizes = [math.prod(s) for _, s, _ in leaves]
    normal = torch.randn(sum(n for n, (_, _, k) in zip(sizes, leaves) if k == "normal"), generator=gen,
                         device=device)
    uniform = torch.rand(sum(n for n, (_, _, k) in zip(sizes, leaves) if k == "uniform"), generator=gen,
                         device=device) * 2.0 - 1.0
    scale = cfg["init_scale"]
    out, at = {}, {"normal": 0, "uniform": 0}
    for (key, shape, kind), n in zip(leaves, sizes):
        if kind == "zero":
            out[key] = torch.zeros(shape, device=device)
            continue
        src = normal if kind == "normal" else uniform
        t = src[at[kind]: at[kind] + n].view(shape)
        at[kind] += n
        fan_in = math.prod(shape[1:])
        out[key] = t * (math.sqrt(scale / fan_in) if kind == "normal" else 1.0 / math.sqrt(fan_in))
    return out
