"""Learned percussive/rest source separator: a mask net over the STFT.

Port of zeronotesamba_tpu/models/separator.py. A small dilated conv net
over the mixture's log-magnitude STFT predicts a 2-way softmax mask (drums
vs rest); train/separator.py trains it on synthetic stem mixtures.

Layout is NCHW: (B, 1, 512, T) in, (B, 2, 512, T) out, with H = 512
frequency bins (the Nyquist bin is carried through unmasked) and the
dilations on the time axis. Flax's ``padding="SAME"`` with an odd kernel
and time dilation d is symmetric: ``(kf // 2, d * (kt // 2))``. The softmax
runs over the channel axis, ``dim=1`` (the JAX package's last axis).

Init is Flax's default: ``lecun_normal`` kernels (a normal truncated at +-2
sd with variance 1 / fan_in) and zero biases, drawn from the generator
given to ``reset_parameters``. The weights of the shipped model are
``SEPARATOR_NPZ``, the JAX package's ``models/separator/`` checkpoint in
its Flax key names (models/weights.load_separator).
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import torch
import torch.nn as nn

from zeronotesamba_torch.models.encoder import fan_in_truncated_normal_

N_FFT = 1024
HOP = 256
N_BINS = 512  # rfft bins minus Nyquist

# (channels, (freq_kernel, time_kernel), time_dilation)
MASK_SPECS: Sequence[Tuple[int, Tuple[int, int], int]] = (
    (24, (5, 3), 1),
    (24, (5, 3), 2),
    (48, (3, 3), 4),
    (48, (3, 3), 8),
    (24, (3, 3), 16),
)
N_STEMS = 2  # mask channel 0 = drums, 1 = rest

SEPARATOR_NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "separator.npz")


class MaskNet(nn.Module):
    """(B, 1, 512, T) log-mag STFT -> (B, 2, 512, T) softmax masks.

    ``convs[0..4]`` are the dilated convs of ``MASK_SPECS`` (Flax
    ``Conv_0..Conv_4``), each followed by a ReLU; ``convs[5]`` is the 1x1
    conv to the two mask logits (``Conv_5``)."""

    def __init__(self):
        super().__init__()
        convs, cin = [], 1
        for ch, (kf, kt), dil in MASK_SPECS:
            convs.append(nn.Conv2d(cin, ch, (kf, kt), padding=(kf // 2, dil * (kt // 2)), dilation=(1, dil)))
            cin = ch
        convs.append(nn.Conv2d(cin, N_STEMS, 1))
        self.convs = nn.ModuleList(convs)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """Flax's default init on the CPU from ``generator``: lecun_normal
        kernels, zero biases."""
        for conv in self.convs:
            w = torch.empty(conv.weight.shape)
            fan_in_truncated_normal_(w, 1.0, generator)
            conv.weight.copy_(w)
            conv.bias.zero_()

    def forward(self, logmag: torch.Tensor) -> torch.Tensor:
        x = logmag
        for conv in self.convs[:-1]:
            x = torch.relu(conv(x))
        return torch.softmax(self.convs[-1](x), dim=1)


def load_separator(path: str = SEPARATOR_NPZ, device: str | torch.device = "cuda") -> MaskNet:
    """A MaskNet in eval mode on ``device`` with the weights of ``path``:
    an ``.npz`` of the Flax tree (the shipped ``SEPARATOR_NPZ``, or what
    train/separator.train_separator saves). An orbax directory, the JAX
    package's format, is refused: export it to an npz first."""
    from zeronotesamba_torch.device import resolve_device
    from zeronotesamba_torch.models.weights import load_state_dict_file

    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package); export it to an npz with "
            "`JAX_PLATFORMS=cpu python tests/test_torch_separator_export.py SRC_DIR DST.npz` and pass the npz"
        )
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: expected an .npz of the MaskNet's Flax tree")
    model = MaskNet()
    model.load_state_dict(load_state_dict_file(path))
    return model.to(resolve_device(device)).eval()
