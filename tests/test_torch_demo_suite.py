"""The port's demo suite against the JAX package's, on the CPU.

``_build_corpus`` runs for real in both: wavs, beats, pulses and names
exact, log-VQTs within 5e-4 (1e-2 in near-empty cells, log |X| <= -7,
which sit at float32 rounding in both packages: tests/test_torch_infer.py).
``run_demo_suite`` runs in both with its training arms (pretext, beat,
cross, few-shot, measures) replaced by the same recording stubs, on tiny
corpora: the stubs must see the same sequence of arm configs, dataset
sizes and initial weights, and the summaries must be equal (old-school F1,
which runs for real, within 1e-6). The ``demo-suite`` CLI must build the
JAX CLI's DemoSuiteConfig from the same flags.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from zeronotesamba_tpu.experiments import beat as jbeat
from zeronotesamba_tpu.experiments import demo_suite as jsuite
from zeronotesamba_tpu import cli as jcli
from zeronotesamba_torch import cli
from zeronotesamba_torch.experiments import beat as tbeat
from zeronotesamba_torch.experiments import demo_suite as suite

torch.set_num_threads(2)

MEASURES = ("l2_l1", "gini", "kurtosis", "shannon", "app_entropy", "samp_entropy", "max_acf")
LOG_FLOOR = -7.0
TINY = dict(n_songs=3, n_songs_b=2, pretext_songs=4, proxy_songs=2, duration_s=2.0, pretext_epochs=3, folds=2,
            max_epochs=3, patience=3, few_shot_sizes=(1, 2), few_shot_repeats=1, few_shot_max_epochs=3, clmr=True,
            seed=1)
CORPUS = dict(bpm_lo=70, bpm_hi=180, freq_lo=700.0, freq_hi=2800.0, seed=1, difficulty=1.0)


def test_build_corpus_equals_jax():
    split, mix, wavs = suite._build_corpus(2, 3.0, device="cpu", **CORPUS)
    j_split, j_mix, j_wavs = jsuite._build_corpus(2, 3.0, **CORPUS)
    assert len(wavs) == len(j_wavs) == 2 and all(np.array_equal(a, b) for a, b in zip(wavs, j_wavs))
    for ours, ref in ((split, j_split), (mix, j_mix)):
        assert ours.names == ref.names
        for a, b in zip(ours, ref):
            assert a.vqt.shape == b.vqt.shape and a.vqt.shape[0] == (2 if ours is split else 1)
            for f in ("pulse", "down_pulse", "beat_times", "downbeat_times"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
            low = b.vqt <= LOG_FLOOR
            np.testing.assert_allclose(a.vqt[~low], b.vqt[~low], rtol=0, atol=5e-4)
            np.testing.assert_allclose(a.vqt[low], b.vqt[low], rtol=0, atol=1e-2)


class _Recorder:
    """The suite's training arms for one package, recording their calls and
    returning the same made-up results in both."""

    def __init__(self, fold_result, quantiles, jax: bool):
        self.calls, self.fold_result, self.quantiles, self.jax = [], fold_result, quantiles, jax
        self.pretext = {"params": "PRETEXT"} if jax else {"anchor.x": "PRETEXT"}

    def _tag(self, params):
        if params is None or isinstance(params, tuple):
            return params
        if self.jax:
            return "pretext" if params == {"params": {"pretext": "PRETEXT"}} else params
        return "pretext" if params is self.pretext else params

    @staticmethod
    def _cfg(cfg):
        keys = ("status", "pre", "lr", "eval_method", "n_folds", "max_epochs", "patience", "batch_size",
                "pos_weight", "seed", "extra_eval_methods", "return_params")
        return tuple(getattr(cfg, k) for k in keys)

    def _folds(self, cfg, n):
        out = []
        for fold in range(n):
            base = 0.1 * len(self.calls) + 0.01 * fold
            m = np.linspace(base, base + 0.5, 6)
            extra = {e: m * 0.5 for e in cfg.extra_eval_methods} or None
            out.append(self.fold_result(fold, m, float(m[0]), 3, extra_metrics=extra,
                                        best_params=("best", cfg.status) if cfg.return_params else None))
        return out

    def train_pretext(self, train_bank, val_bank, cfg, **kw):
        proxy = None if cfg.proxy_dataset is None else len(cfg.proxy_dataset)
        self.calls.append(("pretext", train_bank.shape, val_bank.shape, cfg.task, cfg.num_epochs, cfg.batch_size,
                           cfg.lr, cfg.tracks_per_step, cfg.selection, proxy, cfg.plateau_deadline, cfg.seed))
        hist = {"val_loss": [2.77, 1.5, 1.7], "val_pos": [0.1, 0.6, 0.7], "val_neg": [0.1, 0.2, 0.3],
                "restarts": [], "proxy_f1": [0.3, 0.5, 0.4]}
        if cfg.task == "clmr":
            return ("clmr",), hist
        return self.pretext, hist

    def run_beat_experiment(self, ds, cfg, *, init_params=None, progress=True, **kw):
        self.calls.append(("beat", self._cfg(cfg), len(ds), ds[0].vqt.shape[0], self._tag(init_params)))
        return self._folds(cfg, 1 if cfg.pre == "validation" else cfg.n_folds)

    def run_cross_experiment(self, train_ds, test_ds, cfg, *, init_params=None, **kw):
        self.calls.append(("cross", self._cfg(cfg), len(train_ds), len(test_ds), self._tag(init_params)))
        return self._folds(cfg, cfg.n_folds)

    def run_few_shot(self, ds, cfg, *, train_sizes, repeats, init_params=None, **kw):
        self.calls.append(("few_shot", self._cfg(cfg), len(ds), tuple(train_sizes), repeats, self._tag(init_params)))
        return {s: {"F1": 0.1 * s + len(self.calls), "F1_std": 0.01 * s} for s in train_sizes}

    def measure_arm(self, ds, status, params=None, *, stream="fused", batch_size=8, **kw):
        self.calls.append(("measures", len(ds), ds[0].vqt.shape[0], status, self._tag(params), stream, batch_size))
        v = float(len(self.calls))
        return {m: {**{f"q{q}": v + q for q in self.quantiles}, "mean": v + i} for i, m in enumerate(MEASURES)}

    def install(self, monkeypatch, module):
        for name in ("train_pretext", "run_beat_experiment", "run_cross_experiment", "run_few_shot", "measure_arm"):
            monkeypatch.setattr(module, name, getattr(self, name))


def _key_tree(x):
    return {k: _key_tree(v) for k, v in x.items()} if isinstance(x, dict) else type(x).__name__


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    from zeronotesamba_tpu.experiments.measures import QUANTILES as JQ
    from zeronotesamba_torch.experiments.measures import QUANTILES

    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp("suite")
    j_rec, t_rec = _Recorder(jbeat.FoldResult, JQ, jax=True), _Recorder(tbeat.FoldResult, QUANTILES, jax=False)
    j_rec.install(mp, jsuite)
    t_rec.install(mp, suite)
    try:
        j_out = jsuite.run_demo_suite(jsuite.DemoSuiteConfig(out_dir=str(root / "jax"), **TINY))
        t_out = suite.run_demo_suite(suite.DemoSuiteConfig(out_dir=str(root / "torch"), **TINY), device="cpu")
    finally:
        mp.undo()
    return root, (j_rec, j_out), (t_rec, t_out)


def test_run_demo_suite_calls_the_arms_as_jax_does(suites):
    _, (j_rec, _), (t_rec, _) = suites
    assert len(t_rec.calls) == len(j_rec.calls) == 18
    for ours, ref in zip(t_rec.calls, j_rec.calls):
        assert ours == ref
    kinds = [c[0] for c in t_rec.calls]
    assert kinds == (["pretext"] + ["beat"] * 5 + ["cross", "beat", "few_shot", "few_shot", "pretext", "beat"]
                     + ["measures"] * 6)


def test_run_demo_suite_summary_equals_jax(suites):
    root, (_, j_out), (_, t_out) = suites
    with open(root / "torch" / "summary.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(t_out))
    assert _key_tree(t_out) == _key_tree(j_out)
    j_out, t_out = (json.loads(json.dumps(o)) for o in (j_out, t_out))
    for out in (j_out, t_out):
        out.pop("wall_clock_s")
    for key in ("old_school_f1", "old_school_cmlt"):
        assert abs(t_out["unsupervised"].pop(key) - j_out["unsupervised"].pop(key)) <= 1e-6
    assert t_out == j_out
    for name in ("few_shot_comparison.json", "measures.json"):
        with open(root / "torch" / name) as fh, open(root / "jax" / name) as gh:
            a, b = json.load(fh), json.load(gh)
        assert (a["arms"], list(a["arms"])) == (b["arms"], list(t_out["measures"])) if name == "measures.json" else a == b


def test_chip_smoke_key_tree_is_the_jax_suites(suites):
    """chip_smoke.py holds the card's summary to the committed summary.json's
    key tree brought up to the JAX demo suite's later changes: that tree is
    the one today's JAX demo suite writes."""
    import chip_smoke

    _, (_, j_out), (_, t_out) = suites
    expected = chip_smoke.suite_key_tree(TINY["few_shot_sizes"], clmr=True)
    assert chip_smoke.key_tree(j_out) == chip_smoke.key_tree(t_out) == expected


def test_cli_demo_suite_builds_the_jax_config(monkeypatch, tmp_path):
    seen = {}

    def capture(tag):
        def run(cfg, **kw):
            seen[tag] = (cfg, kw)
            return {}
        return run

    monkeypatch.setattr(suite, "run_demo_suite", capture("torch"))
    monkeypatch.setattr(jsuite, "run_demo_suite", capture("jax"))
    argv = ["demo-suite", "--out", str(tmp_path), "--songs", "5", "--pretext-epochs", "7", "--max-epochs", "9",
            "--folds", "3", "--clmr", "--difficulty", "0.5", "--pretext-selection", "val_loss", "--seed", "4"]
    cli.main(argv + ["--device", "cpu"])
    jcli.main(argv)
    assert dataclasses.asdict(seen["torch"][0]) == dataclasses.asdict(seen["jax"][0])
    assert seen["torch"][1] == {"device": "cpu"}

    cli.main(["demo-suite", "--device", "cpu"])
    jcli.main(["demo-suite"])
    ours, ref = dataclasses.asdict(seen["torch"][0]), dataclasses.asdict(seen["jax"][0])
    assert ours.pop("out_dir") == "results/synthetic_torch" and ref.pop("out_dir") == "results/synthetic"
    assert ours == ref and ours["pretext_epochs"] == 120 and ours["max_epochs"] == 60
