"""Typed experiment configuration, loadable from the reference's YAML format.

The port's copy of zeronotesamba_tpu/experiments/config.py. PyYAML is
imported by ``from_yaml`` alone, so ``from_flat_dict`` runs without it.

The reference threads one flat YAML dict through every script
(configuration/config.yaml, keys like ``ballroom_status`` / ``smc_lr``).
``ZNSConfig.from_yaml`` accepts that exact file format for drop-in parity,
while the dataclasses give the new framework a typed, defaulted surface.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from zeronotesamba_torch.experiments.beat import BeatExperimentConfig

DATASETS = ("smc", "ballroom", "hainsworth", "gtzan")

# Valid Spleeter model names (reference source_separation.py:8-32 validates
# the same set before building its Separator).
SPLEETER_MODELS = ("2stems", "4stems", "5stems", "2stems-16kHz", "4stems-16kHz", "5stems-16kHz")


@dataclasses.dataclass
class AudioConfig:
    clip_len: float = 10.0
    sample_rate: int = 44100
    input_mode: str = "vqt"
    lower_p: float = 0.3
    upper_p: float = 1.0
    spl_mod: str = "4stems"
    pt_data_dir: str = "fma_large/"


@dataclasses.dataclass
class PretextYamlConfig:
    pt_task: str = "zerons"
    lr: float = 1e-6
    temp: float = 0.25
    num_epochs: int = 250
    batch_size: int = 16
    val_len: int = 6400
    train_pkl: int = 2880


@dataclasses.dataclass
class DatasetExperimentConfig:
    exp: str = "beat"  # beat | perc
    status: str = "pretrained"  # pretrained | old-school | clmr | vanilla
    pre: str = "finetune"  # frozen | validation | finetune
    eval: str = "dbn"  # threshold | librosa | dbn
    lr: float = 1e-5


@dataclasses.dataclass
class CrossConfig:
    status: str = "pretrained"
    pre: str = "finetune"
    train_set: str = "smc"
    eval: str = "dbn"
    lr: float = 1e-5


@dataclasses.dataclass
class MeasuresConfig:
    measave: bool = True
    meastatus: str = "std"


@dataclasses.dataclass
class ZNSConfig:
    audio: AudioConfig = dataclasses.field(default_factory=AudioConfig)
    pretext: PretextYamlConfig = dataclasses.field(default_factory=PretextYamlConfig)
    datasets: Dict[str, DatasetExperimentConfig] = dataclasses.field(
        default_factory=lambda: {d: DatasetExperimentConfig() for d in DATASETS}
    )
    cross: CrossConfig = dataclasses.field(default_factory=CrossConfig)
    measures: MeasuresConfig = dataclasses.field(default_factory=MeasuresConfig)

    @classmethod
    def from_yaml(cls, path: str) -> "ZNSConfig":
        import yaml

        with open(path) as fh:
            y: Dict[str, Any] = yaml.safe_load(fh) or {}
        return cls.from_flat_dict(y)

    @classmethod
    def from_flat_dict(cls, y: Dict[str, Any]) -> "ZNSConfig":
        cfg = cls()
        a = cfg.audio
        a.clip_len = float(y.get("clip_len", a.clip_len))
        a.sample_rate = int(y.get("sample_rate", a.sample_rate))
        a.input_mode = str(y.get("input_mode", a.input_mode))
        a.lower_p = float(y.get("lower_p", a.lower_p))
        a.upper_p = float(y.get("upper_p", a.upper_p))
        a.spl_mod = str(y.get("spl_mod", a.spl_mod))
        if a.spl_mod not in SPLEETER_MODELS:
            raise ValueError(f"spl_mod must be one of {SPLEETER_MODELS}, got {a.spl_mod!r}")
        a.pt_data_dir = str(y.get("pt_data_dir", a.pt_data_dir))
        p = cfg.pretext
        p.pt_task = str(y.get("pt_task", p.pt_task))
        p.lr = float(y.get("lr", p.lr))
        p.temp = float(y.get("temp", p.temp))
        p.num_epochs = int(y.get("num_epochs", p.num_epochs))
        p.batch_size = int(y.get("batch_size", p.batch_size))
        p.val_len = int(y.get("val_len", p.val_len))
        p.train_pkl = int(y.get("train_pkl", p.train_pkl))
        for d in DATASETS:
            dc = cfg.datasets[d]
            dc.exp = str(y.get(f"{d}_exp", dc.exp))
            dc.status = str(y.get(f"{d}_status", dc.status))
            dc.pre = str(y.get(f"{d}_pre", dc.pre))
            dc.eval = str(y.get(f"{d}_eval", dc.eval))
            dc.lr = float(y.get(f"{d}_lr", dc.lr))
        c = cfg.cross
        c.status = str(y.get("cross_status", c.status))
        c.pre = str(y.get("cross_pre", c.pre))
        c.train_set = str(y.get("cross_train_set", c.train_set))
        c.eval = str(y.get("cross_eval", c.eval))
        c.lr = float(y.get("cross_lr", c.lr))
        m = cfg.measures
        m.measave = bool(y.get("measave", m.measave))
        m.meastatus = str(y.get("meastatus", m.meastatus))
        return cfg

    def beat_experiment(self, dataset: str, **overrides) -> BeatExperimentConfig:
        dc = self.datasets[dataset]
        kw = dict(status=dc.status, pre=dc.pre, lr=dc.lr, eval_method=dc.eval)
        kw.update(overrides)
        return BeatExperimentConfig(**kw)
