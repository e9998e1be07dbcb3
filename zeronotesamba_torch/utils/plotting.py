"""Training-history figures (port of ``plot_history`` from
zeronotesamba_tpu/utils/plotting.py; the reference's pretext loss PDFs,
pretext.py:418-448). matplotlib is imported when a figure is drawn, so a
caller without it gets its ImportError there."""

from __future__ import annotations

import os
from typing import Dict, Sequence


def _save(fig, path: str):
    import matplotlib.pyplot as plt

    os.makedirs(os.path.dirname(path) or "figures", exist_ok=True)
    fig.savefig(path, dpi=200)
    plt.close(fig)


def plot_history(hist: Dict[str, Sequence[float]], save_prefix: str):
    """Loss + similarity curves: ``<save_prefix>_loss.pdf`` and ``_similarity.pdf``."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 5))
    for key in ("train_loss", "val_loss"):
        if key in hist:
            ax.plot(hist[key], label=key)
    ax.set_xlabel("epoch")
    ax.legend()
    _save(fig, save_prefix + "_loss.pdf")

    fig, ax = plt.subplots(figsize=(15, 5))
    for key in ("train_pos", "train_neg", "val_pos", "val_neg"):
        if key in hist:
            ax.plot(hist[key], label=key)
    ax.set_xlabel("epoch")
    ax.legend()
    _save(fig, save_prefix + "_similarity.pdf")
