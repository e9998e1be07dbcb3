"""Plotting utilities (port of zeronotesamba_tpu/utils/plotting.py; the
reference's input_rep.plot_XQT, sample_script.py:55-92 overlays and pretext
loss PDFs, pretext.py:418-448). matplotlib is imported when a figure is
drawn, so a caller without it gets its ImportError there."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np


def _save_or_show(fig, save: Optional[str]):
    import matplotlib.pyplot as plt

    if save is None:
        plt.show()
    else:
        os.makedirs(os.path.dirname(save) or "figures", exist_ok=True)
        fig.savefig(save, dpi=200)
        plt.close(fig)


def plot_xqt(log_mag: np.ndarray, sample_rate: int = 16000, title: Optional[str] = None, save: Optional[str] = None):
    """Log-VQT heatmap (reference input_rep.plot_XQT, input_rep.py:60-87)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 4))
    db = 20.0 * (log_mag - log_mag.max()) / np.log(10.0)  # amplitude -> dB re max
    img = ax.imshow(db, aspect="auto", origin="lower", cmap="magma", vmin=-80, vmax=0)
    ax.set_xlabel("frame (62.5 fps)")
    ax.set_ylabel("VQT bin")
    ax.set_title(title or "Power spectrum")
    fig.colorbar(img, ax=ax, format="%+2.0f dB")
    _save_or_show(fig, save)


def plot_pulse_over_waveform(
    signal: np.ndarray, pulse: np.ndarray, sr: int = 16000, fps: float = 62.5,
    beat_times: Optional[np.ndarray] = None, title: Optional[str] = None, save: Optional[str] = None,
):
    """Waveform with the model pulse overlay (reference sample_script.py:55-92)."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 5))
    t_sig = np.arange(len(signal)) / sr
    ax.plot(t_sig, signal, color="0.7", lw=0.5, label="waveform")
    t_pulse = np.arange(len(pulse)) / fps
    ax.plot(t_pulse, pulse, color="C1", lw=1.5, label="pulse")
    if beat_times is not None:
        for bt in beat_times:
            ax.axvline(bt, color="C2", ls="--", lw=0.8, alpha=0.7)
    ax.set_xlabel("time (s)")
    ax.legend(loc="upper right")
    if title:
        ax.set_title(title)
    _save_or_show(fig, save)


def plot_history(hist: Dict[str, Sequence[float]], save_prefix: str):
    """Loss + similarity curves: ``<save_prefix>_loss.pdf`` and ``_similarity.pdf``."""
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(15, 5))
    for key in ("train_loss", "val_loss"):
        if key in hist:
            ax.plot(hist[key], label=key)
    ax.set_xlabel("epoch")
    ax.legend()
    _save_or_show(fig, save_prefix + "_loss.pdf")

    fig, ax = plt.subplots(figsize=(15, 5))
    for key in ("train_pos", "train_neg", "val_pos", "val_neg"):
        if key in hist:
            ax.plot(hist[key], label=key)
    ax.set_xlabel("epoch")
    ax.legend()
    _save_or_show(fig, save_prefix + "_similarity.pdf")
