"""The port's pretext driver around its engine: the plateau watchdog, seeded
dropout, checkpoint selection, resume, figures and traces, the host-batch
step, the ``pretext`` CLI, and a written checkpoint loading into inference
and the beat experiment. The JAX package's own cases
(tests/test_plateau_watchdog.py, test_selection.py, test_resume.py) run on
the port with the full-width model at a smaller size (batch 2, crops of 8
frames, bank items of 16, one train and one validation track); the CLI runs
at its fixed 313-frame crop.

Tolerances: the proxy F1 of the returned params 1e-6 from the best in the
history; everything else is exact (counts, files, equal runs).
"""

import json
import os

import numpy as np
import pytest
import torch

from zeronotesamba_torch import cli
from zeronotesamba_torch.data.datasets import build_synthetic
from zeronotesamba_torch.experiments.beat import BeatExperimentConfig, run_beat_experiment
from zeronotesamba_torch.experiments.pretext_driver import PretextRunConfig, train_pretext, zero_shot_proxy_f1
from zeronotesamba_torch.infer import BeatTracker
from zeronotesamba_torch.models.encoder import DSCNN
from zeronotesamba_torch.train.checkpoint import load_params
from zeronotesamba_torch.train.pretext import (
    PretextConfig,
    batches_from_bank,
    init_pretext_state,
    make_staged_train_step,
    make_train_step,
)
from zeronotesamba_torch.utils.plotting import plot_history

torch.set_num_threads(2)

B, CROP, FRAMES = 2, 8, 16
SMALL = dict(task="zerons", batch_size=B, crop_frames=CROP, lr=1e-4, seed=0)


def _bank(n=4, frames=FRAMES, seed=0):
    return (np.random.default_rng(seed).standard_normal((n, 2, 96, frames)) * 4.0 - 6.0).astype(np.float32)


def _run(bank, **kw):
    """One train track, one validation track."""
    return train_pretext(bank[1:2], bank[:1], PretextRunConfig(**{**SMALL, **kw}), device="cpu")


def test_watchdog_restarts_when_never_escaped():
    # margin 10 makes escape impossible (val loss cannot go below ln(2) - 10),
    # so each non-final attempt is cut at the deadline and the final attempt
    # runs the whole budget: 2 x 1 + 3 = 5 epochs.
    _, hist = _run(_bank(), num_epochs=3, plateau_deadline=1, plateau_margin=10.0, plateau_restarts=2)
    assert len(hist["val_loss"]) == 5
    assert hist["restarts"] == [1, 2]


def test_watchdog_no_restart_when_escaped():
    # margin -10: any val loss counts as escaped, so one attempt runs it all.
    _, hist = _run(_bank(), num_epochs=2, plateau_deadline=1, plateau_margin=-10.0, plateau_restarts=2)
    assert len(hist["val_loss"]) == 2 and hist["restarts"] == []


def test_watchdog_disabled_is_reference_parity():
    _, h0 = _run(_bank(), num_epochs=2)
    # restarts=0 with a deadline set trains identically (one attempt, whole budget)
    _, h1 = _run(_bank(), num_epochs=2, plateau_deadline=2, plateau_margin=10.0, plateau_restarts=0)
    assert h0["val_loss"] == h1["val_loss"] and h1["restarts"] == []


def test_watchdog_restart_uses_fresh_stream():
    # The restarted attempt starts from another init (seed + 1000).
    _, hist = _run(_bank(), num_epochs=2, plateau_deadline=1, plateau_margin=10.0, plateau_restarts=1)
    assert len(hist["val_loss"]) == 3 and hist["val_loss"][0] != hist["val_loss"][1]


def test_steps_per_call_and_rng_impl_have_no_effect():
    """The JAX driver's dispatch options. ``rng_impl``, ``scan_unroll`` and
    ``freq_s2d`` change nothing; S = 4 on an epoch of 4 updates (4 train
    tracks) needs no pad, so its one 4-step call repeats the S = 1 run
    exactly, dropout included."""
    bank = _bank(5)
    runs = [train_pretext(bank[:4], bank[4:], PretextRunConfig(**{**SMALL, "num_epochs": 2, **kw}), device="cpu")
            for kw in ({}, dict(rng_impl="threefry", scan_unroll=True, freq_s2d=(1,)), dict(steps_per_call=4))]
    (b0, h0) = runs[0]
    for b1, h1 in runs[1:]:
        assert h0 == h1
        assert all(torch.equal(b0[k], b1[k]) for k in b0)


def test_seeded_dropout_repeats_exactly():
    """Dropout is on (0.1) in the driver: the same seed repeats the run, and
    another seed differs."""
    out = [_run(_bank(), num_epochs=1, seed=s)[1]["train_loss"] for s in (0, 0, 1)]
    assert out[0] == out[1] != out[2]


def test_host_batch_step_equals_the_staged_step():
    """make_train_step on host-cropped batches (batches_from_bank) and the
    staged step on the same (track, starts) give the same loss and weights."""
    cfg = PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0, lr=1e-4)
    bank = _bank()
    batch = next(batches_from_bank(bank, cfg, np.random.default_rng(3)))
    rng = np.random.default_rng(3)
    track = int(rng.permutation(len(bank))[0])
    starts = rng.choice(FRAMES - CROP + 1, size=B, replace=False)
    host, staged = (init_pretext_state(cfg, 5, device="cpu") for _ in range(2))
    host, loss_h, *_ = make_train_step(cfg)(host, torch.tensor(batch), None)
    staged, loss_s, *_ = make_staged_train_step(cfg)(staged, torch.tensor(bank), track, starts, None)
    assert loss_h.item() == loss_s.item()
    assert all(torch.equal(a, b) for a, b in zip(host.model.parameters(), staged.model.parameters()))


@pytest.fixture(scope="module")
def proxy():
    return build_synthetic(2, 2.0, seed=5, device="cpu")


def test_proxy_selection_tracks_and_checkpoints_both(tmp_path, proxy):
    ckpt = str(tmp_path / "ck.pth")
    best, hist = _run(_bank(), num_epochs=2, checkpoint_path=ckpt, selection="proxy_f1", proxy_dataset=proxy,
                      proxy_every=1, proxy_eval_method="threshold")
    assert len(hist["proxy_f1"]) == 2 and hist["proxy_epoch"] == [0, 1]
    assert all(0.0 <= f <= 1.0 for f in hist["proxy_f1"])
    # The selected (proxy) checkpoint at the path, the val-loss one beside it.
    assert os.path.exists(ckpt) and os.path.exists(str(tmp_path / "ck_valsel.pth"))
    saved = load_params(ckpt)
    assert all(torch.equal(saved[k], best[k]) for k in best)
    f1 = zero_shot_proxy_f1(proxy, best, eval_method="threshold", device="cpu")
    assert f1 == pytest.approx(max(hist["proxy_f1"]), abs=1e-6)

    # The .pth in the reference Pretext_CNN keys loads into inference and
    # into the zero-shot beat experiment.
    assert all(k.startswith(("anchor.", "postve.")) for k in saved)
    tracker = BeatTracker(saved, device="cpu")
    assert all(torch.equal(v, saved[k]) for k, v in tracker.state_dict().items())
    cfg = BeatExperimentConfig(status="pretrained", pre="validation", eval_method="threshold", batch_size=1,
                               bucket_frames=32, return_params=True)
    (res,) = run_beat_experiment(build_synthetic(1, 0.5, seed=3, device="cpu"), cfg, init_params=saved, device="cpu")
    assert all(torch.equal(res.best_params["pretext." + k], v) for k, v in saved.items())


def test_selection_errors():
    bank = np.zeros((4, 2, 96, FRAMES), np.float32)
    with pytest.raises(ValueError, match="proxy_dataset"):
        _run(bank, selection="proxy_f1", num_epochs=1)
    with pytest.raises(ValueError, match="unknown selection"):
        _run(bank, selection="f1", num_epochs=1)
    with pytest.raises(ValueError, match="zerons"):
        _run(bank, task="clmr", selection="proxy_f1", proxy_dataset=object(), num_epochs=1)


def test_pretext_resume_continues(tmp_path):
    resume = str(tmp_path / "resume")
    _, h1 = _run(_bank(), num_epochs=2, resume_dir=resume)
    assert len(h1["val_loss"]) == 2
    # A restart with the same resume_dir and a larger budget continues at epoch 2.
    _, h2 = _run(_bank(), num_epochs=4, resume_dir=resume)
    assert len(h2["val_loss"]) == 2
    assert sorted(os.listdir(resume)) == ["ckpt_1.pt", "ckpt_2.pt", "ckpt_3.pt"]


def test_figures_and_trace(tmp_path):
    """figures_path draws with matplotlib, and raises its ImportError where
    matplotlib is absent; trace_dir writes a Chrome trace of the first epoch."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            plot_history({"train_loss": [1.0]}, str(tmp_path / "f"))
        return
    figs, traces = str(tmp_path / "figs" / "run"), str(tmp_path / "traces")
    _run(_bank(), num_epochs=2, figures_path=figs, figures_every=2, trace_dir=traces)
    assert sorted(os.listdir(tmp_path / "figs")) == ["run_loss.pdf", "run_similarity.pdf"]
    (name,) = os.listdir(traces)
    with open(os.path.join(traces, name)) as fh:
        assert json.load(fh)["traceEvents"]


def test_cli_pretext_on_cpu(tmp_path, capsys):
    """``pretext --bank`` at the CLI's 313-frame crop; the single-encoder
    task keeps it short."""
    bank = str(tmp_path / "bank.npz")
    full = _bank(2, frames=320, seed=4)
    np.savez(bank, train_bank=full[:1], val_bank=full[1:])
    ckpt = str(tmp_path / "models" / "clmr.pth")
    cli.main(["pretext", "--bank", bank, "--task", "clmr", "--epochs", "1", "--batch-size", "2",
              "--checkpoint", ckpt, "--steps-per-call", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checkpoint"] == ckpt and out["epochs"] == 1 and np.isfinite(out["best_val_loss"])
    sd = load_params(ckpt)
    assert sorted(sd) == sorted(DSCNN().state_dict())  # the reference DS_CNN keys
    with pytest.raises(SystemExit):
        cli.main(["pretext", "--device", "cpu"])
