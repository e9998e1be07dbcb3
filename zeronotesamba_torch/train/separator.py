"""Training engine for the learned percussive/rest separator.

Port of zeronotesamba_tpu/train/separator.py. Synthetic stem mixtures
(data/synthetic.percussive_pair: the true stems come free) stay on the
device as waveforms; every train step crops random windows there, runs
STFT + MaskNet + masked-magnitude L1 against the true stems' magnitudes and
an Adam step. The evaluation metric is the SI-SDR of the masked waveforms
against the true stems, beside the HPSS baseline (ops/hpss.py). The host
sends a handful of int64 crop offsets a step.

The STFT pair is the port's ``ops/hpss._stft`` / ``_istft`` (the JAX
package's hand-written pair). The MaskNet's convs are cuDNN's, with TF32
off on the card. A checkpoint is the MaskNet's Flax tree as an ``.npz``
(``save_separator``), the form of the shipped model, so
``--sep-model`` reads either the same way.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from zeronotesamba_torch.device import disable_tf32, resolve_device
from zeronotesamba_torch.models.separator import HOP, N_BINS, N_FFT, MaskNet
from zeronotesamba_torch.models.weights import flatten_flax, load_weights, separator_jax_from_state_dict
from zeronotesamba_torch.ops.hpss import _istft, _stft
from zeronotesamba_torch.train.state import ADAM_BETAS, ADAM_EPS, TrainState
from zeronotesamba_torch.utils.logging import get_logger

log = get_logger("train.separator")

CROP_FRAMES = 256  # ~4.1 s at hop 256
CROP_LEN = (CROP_FRAMES - 1) * HOP


@dataclasses.dataclass
class SeparatorConfig:
    steps: int = 1500
    batch_size: int = 8
    lr: float = 3e-4
    seed: int = 0
    eval_every: int = 250
    checkpoint_path: Optional[str] = None  # an .npz of the MaskNet's Flax tree


def _features(mix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) waveform -> (complex spec (B, F, T), logmag input (B, 1, 512, T))."""
    spec = _stft(mix, N_FFT, HOP)
    logmag = torch.log1p(spec[:, :N_BINS, :].abs())
    return spec, logmag[:, None]


def apply_masks(spec: torch.Tensor, masks: torch.Tensor, length: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask the mixture spec (mixture phase) and invert to waveforms.

    ``masks`` is (B, 2, 512, T); the Nyquist row reuses mask bin 511 of
    each stem (negligible energy at 8 kHz for 16 kHz audio)."""
    full = torch.cat([masks, masks[:, :, -1:, :]], dim=2)  # (B, 2, F, T)
    drums = _istft(spec * full[:, 0], N_FFT, HOP, length)
    rest = _istft(spec * full[:, 1], N_FFT, HOP, length)
    return drums, rest


def si_sdr(est: torch.Tensor, ref: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Scale-invariant SDR in dB over the last axis (Le Roux et al. 2019)."""
    ref_energy = torch.sum(ref * ref, dim=-1, keepdim=True)
    proj = torch.sum(est * ref, dim=-1, keepdim=True) / (ref_energy + eps) * ref
    noise = est - proj
    ratio = torch.sum(proj * proj, dim=-1) / (torch.sum(noise * noise, dim=-1) + eps)
    return 10.0 * torch.log10(ratio + eps)


def init_separator_state(cfg: SeparatorConfig, seed: int, *, params=None,
                         device: str | torch.device = "cuda") -> TrainState:
    """A MaskNet and its Adam (optax.adam's defaults) on ``device``: Flax's
    default init drawn on the CPU from ``seed``, or a copy of ``params`` (a
    state dict or the Flax tree)."""
    dev = resolve_device(device)
    disable_tf32()
    model = MaskNet()
    if params is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
    else:
        load_weights(model, params)
    model.to(dev)
    return TrainState(model, torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=ADAM_BETAS, eps=ADAM_EPS))


def _crop(bank: torch.Tensor, song: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """bank (N, S, L) -> (B, S, CROP_LEN) windows, on the bank's device."""
    rows = bank.index_select(0, song)  # (B, S, L)
    idx = offs[:, None, None] + torch.arange(CROP_LEN, device=bank.device)
    return torch.gather(rows, 2, idx.expand(-1, rows.shape[1], -1))


def train_step(state: TrainState, bank: torch.Tensor, song: torch.Tensor, offs: torch.Tensor):
    """One Adam step on crops of ``bank``, whose rows are (mix, drums, rest)
    waveform triples; returns the state and the loss (a 0-d tensor on the
    device). The parameters' ``grad`` holds this step's gradients after."""
    with torch.no_grad():
        crops = _crop(bank, song, offs)
        mix, drums_ref, rest_ref = crops[:, 0], crops[:, 1], crops[:, 2]
        spec, logmag = _features(mix)
        mag = spec[:, :N_BINS, :].abs()
        mag_d = _stft(drums_ref, N_FFT, HOP)[:, :N_BINS, :].abs()
        mag_r = _stft(rest_ref, N_FFT, HOP)[:, :N_BINS, :].abs()
    state.optimizer.zero_grad(set_to_none=True)
    masks = state.model(logmag)
    loss = torch.mean(torch.abs(mag * masks[:, 0] - mag_d)) + torch.mean(torch.abs(mag * masks[:, 1] - mag_r))
    loss.backward()
    state.optimizer.step()
    state.step += 1
    return state, loss.detach()


@torch.no_grad()
def eval_si_sdr(model: MaskNet, mix: torch.Tensor, drums_ref: torch.Tensor, rest_ref: torch.Tensor):
    """Mean SI-SDR (dB) of both masked stems on full-length signals, as
    0-d tensors (drums, rest)."""
    spec, logmag = _features(mix)
    drums, rest = apply_masks(spec, model(logmag), mix.shape[-1])
    return torch.mean(si_sdr(drums, drums_ref)), torch.mean(si_sdr(rest, rest_ref))


@torch.no_grad()
def separate_learned(signal: np.ndarray, model: MaskNet) -> Tuple[np.ndarray, np.ndarray]:
    """Full-length host API: mono waveform -> (drums, rest), through
    ``model`` on its device."""
    dev = next(model.parameters()).device
    y = torch.as_tensor(np.asarray(signal, dtype=np.float32), device=dev)[None, :]
    spec, logmag = _features(y)
    drums, rest = apply_masks(spec, model(logmag), y.shape[-1])
    return drums[0].cpu().numpy(), rest[0].cpu().numpy()


def synth_bank(n_songs: int, duration_s: float, seed: int, sr: int = 16000) -> np.ndarray:
    """(N, 3, L) rows of (mix, drums, rest) from the hardened synthetic preset.

    Difficulty knobs are drawn per song across the full demo range, as the
    demo corpora are (experiments/demo_suite._build_corpus), minus stem
    bleed (targets must be the true stems)."""
    from zeronotesamba_torch.data.synthetic import percussive_pair

    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_songs):
        bpm = float(rng.uniform(60, 180))
        freq = float(np.exp(rng.uniform(np.log(550.0), np.log(2800.0))))
        rest, drums, _ = percussive_pair(
            duration_s, bpm, sr, seed=seed * 7919 + i, harmonics=5, click_freq=freq,
            jitter_s=float(rng.uniform(0.0, 0.025)), drift=float(rng.uniform(0.0, 0.06)),
            amp_sd=0.35, drop_p=0.12, offbeat=float(rng.uniform(0.0, 0.95)),
            harm_offbeat=0.35, noise=0.002,
        )
        mix = rest + drums
        rows.append(np.stack([mix, drums, rest]))
    return np.stack(rows).astype(np.float32)


def _cpu_state_dict(model: MaskNet) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def train_separator(
    cfg: SeparatorConfig,
    *,
    train_songs: int = 40,
    val_songs: int = 8,
    duration_s: float = 12.0,
    device: str | torch.device = "cuda",
) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Train on synthetic mixtures on ``device``; returns (the best MaskNet
    state dict on the CPU, history with SI-SDR). Evaluation runs every
    ``eval_every`` steps and at the last step; the best params are those of
    the highest drums + rest SI-SDR."""
    dev = resolve_device(device)
    bank = synth_bank(train_songs, duration_s, cfg.seed)
    val = synth_bank(val_songs, duration_s, cfg.seed + 999)
    bank_dev = torch.as_tensor(bank, device=dev)
    val_mix, val_drums, val_rest = (torch.as_tensor(val[:, i], device=dev) for i in range(3))

    state = init_separator_state(cfg, cfg.seed, device=dev)
    rng = np.random.default_rng(cfg.seed + 1)
    max_off = bank.shape[-1] - CROP_LEN
    hist: Dict[str, list] = {"loss": [], "si_sdr_drums": [], "si_sdr_rest": []}
    best = -np.inf
    best_params = _cpu_state_dict(state.model)
    for it in range(cfg.steps):
        # The JAX order of host draws: songs, then offsets, each step.
        song = rng.integers(0, train_songs, size=cfg.batch_size, dtype=np.int32)
        offs = rng.integers(0, max_off + 1, size=cfg.batch_size, dtype=np.int32)
        state, loss = train_step(state, bank_dev, *(torch.as_tensor(a, dtype=torch.int64, device=dev)
                                                    for a in (song, offs)))
        if (it + 1) % cfg.eval_every == 0 or it == cfg.steps - 1:
            sd, sr_ = (float(v) for v in eval_si_sdr(state.model, val_mix, val_drums, val_rest))
            hist["loss"].append(float(loss))
            hist["si_sdr_drums"].append(sd)
            hist["si_sdr_rest"].append(sr_)
            log.info("step %d: loss=%.4f si_sdr drums=%.2f dB rest=%.2f dB", it + 1, float(loss), sd, sr_)
            if sd + sr_ > best:
                best = sd + sr_
                best_params = _cpu_state_dict(state.model)
    if cfg.checkpoint_path:
        save_separator(cfg.checkpoint_path, best_params)
    return best_params, hist


def save_separator(path: str, state_dict: Dict[str, torch.Tensor]) -> None:
    """A MaskNet state dict -> ``path``, an ``.npz`` of its Flax tree."""
    if not path.endswith(".npz"):
        raise ValueError(f"{path}: the separator checkpoint is an .npz")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flatten_flax(separator_jax_from_state_dict(state_dict)))


def hpss_baseline_si_sdr(val: np.ndarray, device: str | torch.device = "cuda") -> Tuple[float, float]:
    """SI-SDR of the HPSS split on the same (mix, drums, rest) rows, on ``device``."""
    from zeronotesamba_torch.ops.hpss import hpss

    dev = resolve_device(device)
    with torch.no_grad():
        h, p = hpss(torch.as_tensor(val[:, 0], device=dev))
        return (
            float(torch.mean(si_sdr(p, torch.as_tensor(val[:, 1], device=dev)))),
            float(torch.mean(si_sdr(h, torch.as_tensor(val[:, 2], device=dev)))),
        )
