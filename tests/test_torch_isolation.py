"""The port stands alone: no JAX import anywhere in it, and its entry points
run on the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zeronotesamba_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "zeronotesamba_tpu")

torch.set_num_threads(2)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _modules():
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py" or rel.endswith("__main__.py"):
            continue
        mod = rel[:-3].replace(os.sep, ".")
        mods.append(mod[: -len(".__init__")] if mod.endswith(".__init__") else mod)
    return mods


def test_no_forbidden_imports():
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}: {n}" for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_modules()) >= 20


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


def test_entry_points_need_a_card_unless_asked_for_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the CUDA default is valid here")
    from zeronotesamba_torch import cli
    from zeronotesamba_torch.data.fma import gen_clmr_bank, mine_stems
    from zeronotesamba_torch.experiments.pretext_driver import (
        PretextRunConfig,
        build_bank_from_stem_root,
        train_pretext,
    )
    from zeronotesamba_torch.infer import BeatTracker
    from zeronotesamba_torch.ops.hpss import hpss_host
    from zeronotesamba_torch.ops.vqt import generate_xqt
    from zeronotesamba_torch.experiments.demo_suite import DemoSuiteConfig, run_demo_suite
    from zeronotesamba_torch.models.separator import load_separator
    from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state
    from zeronotesamba_torch.train.separator import (
        SeparatorConfig, hpss_baseline_si_sdr, init_separator_state, train_separator,
    )

    sig = np.zeros(4000, np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        BeatTracker()
    with pytest.raises(RuntimeError, match="cuda"):
        generate_xqt(sig, 16000, "vqt")
    with pytest.raises(RuntimeError, match="cuda"):
        hpss_host(sig)
    assert generate_xqt(sig, 16000, "vqt", device="cpu").shape == (96, 16)

    bank = np.zeros((2, 2, 96, 16), np.float32)
    np.savez(str(tmp_path / "bank.npz"), train_bank=bank[:1], val_bank=bank[1:])
    for call in (lambda: train_pretext(bank[:1], bank[1:], PretextRunConfig(batch_size=2, crop_frames=8)),
                 lambda: init_pretext_state(PretextConfig(), 0),
                 lambda: build_bank_from_stem_root(str(tmp_path), 1),
                 lambda: mine_stems(str(tmp_path), str(tmp_path / "out")),
                 lambda: gen_clmr_bank(str(tmp_path), 1),
                 lambda: cli.main(["pretext", "--bank", str(tmp_path / "bank.npz"), "--epochs", "1"]),
                 lambda: cli.main(["pretext", "--bank", str(tmp_path / "bank.npz"), "--epochs", "1",
                                   "--data-parallel"]),
                 lambda: load_separator(),
                 lambda: init_separator_state(SeparatorConfig(), 0),
                 lambda: train_separator(SeparatorConfig(steps=1), train_songs=1, val_songs=1, duration_s=4.2),
                 lambda: hpss_baseline_si_sdr(np.zeros((1, 3, 4000), np.float32)),
                 lambda: run_demo_suite(DemoSuiteConfig(out_dir=str(tmp_path / "suite"), n_songs=1)),
                 lambda: cli.main(["train-separator", "--steps", "1", "--checkpoint", str(tmp_path / "s.npz")]),
                 lambda: cli.main(["infer", str(tmp_path / "x.wav"), "--separation", "learned"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


def test_kernel_sources_ship_with_the_package(tmp_path, monkeypatch):
    """Every CUDA source and header, the native DBN's C++ source and the shipped
    separator's weights are declared package data, and a copy that lacks a
    source says so before it tries to build."""
    import tomllib

    from zeronotesamba_torch.decode import dbn_native
    from zeronotesamba_torch.models.separator import SEPARATOR_NPZ
    from zeronotesamba_torch.ops.cuda import build

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        data = tomllib.load(fh)["tool"]["setuptools"]["package-data"]["zeronotesamba_torch"]
    assert data == ["csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp", "assets/*.npz"]
    assert os.path.relpath(SEPARATOR_NPZ, PKG) == os.path.join("assets", "separator.npz") and os.path.isfile(SEPARATOR_NPZ)
    assert all((build.CSRC / f"{name}.cu").is_file() for name in build.SOURCES)
    assert dbn_native.SOURCE.is_file() and dbn_native.SOURCE.parent == build.CSRC
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(FileNotFoundError, match="cannot be built"):
        build.build_dir()
    monkeypatch.setattr(dbn_native, "SOURCE", tmp_path / "dbn_viterbi.cpp")
    with pytest.raises(FileNotFoundError, match="cannot be built"):
        dbn_native.library_path()
