"""The port's experiments, measures and new CLI subcommands against the JAX
package's: the YAML config, the cross-dataset and few-shot experiments, the
embedding measures, and cross / few-shot / measures / old-school / resave /
track-dir on the CPU.

Tolerances: config fields and every split exact; the experiments' test F1 from
the same transplanted weights at max_epochs=0 with DBN decoding within 1e-6
(the pulses agree within float32 rounding and the DBN picks the same
beats); the numpy measures at 1e-12 on one pulse; ``measure_arm``'s smooth
entries (L2/L1, Gini, kurtosis, max autocorrelation) at 1e-4 relative, its
entropies left out (histogram bins and distance thresholds are not smooth
in the pulse).
"""

import csv
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest
import torch

from zeronotesamba_tpu.data.datasets import BeatDataset as JBeatDataset
from zeronotesamba_tpu.data.datasets import SongRecord as JSongRecord
from zeronotesamba_tpu.experiments import cross as jcross
from zeronotesamba_tpu.experiments import few_shot as jfew
from zeronotesamba_tpu.experiments import measures as jmeasures
from zeronotesamba_tpu.experiments.beat import BeatExperimentConfig as JBeatConfig
from zeronotesamba_tpu.experiments.config import ZNSConfig as JZNSConfig
from zeronotesamba_tpu.train import supervised as jsup
from zeronotesamba_tpu.utils.xlsx import read_xlsx as j_read_xlsx
from zeronotesamba_torch import cli
from zeronotesamba_torch.data import audio_io
from zeronotesamba_torch.data.datasets import BeatDataset, SongRecord, build_synthetic
from zeronotesamba_torch.data.synthetic import click_track
from zeronotesamba_torch.experiments import cross, few_shot, measures
from zeronotesamba_torch.experiments.beat import BeatExperimentConfig
from zeronotesamba_torch.experiments.config import DATASETS, ZNSConfig
from zeronotesamba_torch.infer import BeatTracker
from zeronotesamba_torch.models.separator import SEPARATOR_NPZ
from zeronotesamba_torch.train.checkpoint import save_params
from zeronotesamba_torch.utils.xlsx import read_xlsx

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMOOTH = ("l2_l1", "gini", "kurtosis", "max_acf")
METRICS = ("F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain")

# The keys tests/test_experiments.py reads from the reference's config.yaml,
# with the values it asserts, and one more per section.
YAML = """\
clip_len: 10
sample_rate: 44100
spl_mod: 4stems
pt_task: clmr
batch_size: 16
lr: 1.0e-06
num_epochs: 250
gtzan_status: pretrained
gtzan_eval: dbn
smc_lr: 1.0e-05
smc_pre: frozen
ballroom_exp: perc
cross_train_set: smc
cross_status: clmr
measave: false
meastatus: drums
"""


# --------------------------------------------------------------------------
# Config
# --------------------------------------------------------------------------


def test_config_from_yaml_equals_jax(tmp_path):
    path = str(tmp_path / "config.yaml")
    with open(path, "w") as fh:
        fh.write(YAML)
    cfg, ref = ZNSConfig.from_yaml(path), JZNSConfig.from_yaml(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.audio.clip_len == 10 and cfg.pretext.pt_task == "clmr" and cfg.pretext.batch_size == 16
    assert cfg.datasets["gtzan"].status == "pretrained" and cfg.datasets["smc"].lr == pytest.approx(1e-5)
    assert cfg.cross.train_set == "smc"
    for d in DATASETS:
        ours, theirs = cfg.beat_experiment(d, n_folds=4), ref.beat_experiment(d, n_folds=4)
        for f in ("status", "pre", "lr", "eval_method", "n_folds"):
            assert getattr(ours, f) == getattr(theirs, f), (d, f)
    bec = cfg.beat_experiment("gtzan")
    assert isinstance(bec, BeatExperimentConfig) and bec.status == "pretrained" and bec.eval_method == "dbn"


def test_config_from_flat_dict_equals_jax_and_checks_spleeter():
    y = {"clip_len": 5, "hainsworth_eval": "librosa", "cross_lr": 3e-4, "upper_p": 0.9, "train_pkl": 10}
    assert dataclasses.asdict(ZNSConfig.from_flat_dict(y)) == dataclasses.asdict(JZNSConfig.from_flat_dict(y))
    assert dataclasses.asdict(ZNSConfig.from_flat_dict({})) == dataclasses.asdict(JZNSConfig())
    with pytest.raises(ValueError, match="spl_mod"):
        ZNSConfig.from_flat_dict({"spl_mod": "3stems"})


# --------------------------------------------------------------------------
# The experiments' splits, against the JAX experiments with training stubbed out
# --------------------------------------------------------------------------


class _Recorder:
    """Stands in for StagedDataset: records every plan's song order."""

    log: list = []

    def __init__(self, records, bucket_frames, **kw):
        pass

    def plan(self, names, batch_size, shuffle_rng=None):
        order = list(names)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        _Recorder.log.append(order)
        return []


class _State:
    params = {}
    model = torch.nn.Module()

    def replace(self, **kw):
        return self


def _stub(monkeypatch, module):
    monkeypatch.setattr(module, "StagedDataset", _Recorder)
    monkeypatch.setattr(module, "init_state", lambda *a, **kw: _State())
    monkeypatch.setattr(module, "run_epoch", lambda state, *a, **kw: (state, 0.0, np.zeros(6)))


def _names_only(n):
    return BeatDataset([SongRecord(f"song{i:02d}", np.zeros((1, 96, 8), np.float32), np.zeros(8), np.zeros(8),
                                   np.zeros(1), np.zeros(0)) for i in range(n)])


def _plans(monkeypatch, jax_module, port_module, run):
    logs = []
    for module in (jax_module, port_module):
        _stub(monkeypatch, module)
        _Recorder.log = []
        run(module)
        logs.append(_Recorder.log)
    return logs


@pytest.mark.parametrize("n,folds,seed", [(13, 3, 0), (10, 2, 5)])
def test_cross_splits_equal_jax(monkeypatch, n, folds, seed):
    monkeypatch.setattr(cross, "_clone_params", lambda model: {})
    train, test = _names_only(n), _names_only(4)
    cfgs = {jcross: JBeatConfig(n_folds=folds, max_epochs=2, patience=5, seed=seed),
            cross: BeatExperimentConfig(n_folds=folds, max_epochs=2, patience=5, seed=seed)}
    ours_log, ref_log = _plans(monkeypatch, jcross, cross,
                               lambda m: m.run_cross_experiment(train, test, cfgs[m]))[::-1]
    assert ours_log == ref_log and len(ours_log) == 1 + folds * 3  # test; per fold: val, 2 epochs' train


@pytest.mark.parametrize("n,seed", [(16, 0), (11, 3)])
def test_few_shot_splits_equal_jax(monkeypatch, n, seed):
    monkeypatch.setattr(few_shot, "_clone_params", lambda model: {})
    ds = _names_only(n)
    cfgs = {jfew: JBeatConfig(max_epochs=2, patience=5, seed=seed),
            few_shot: BeatExperimentConfig(max_epochs=2, patience=5, seed=seed)}
    ref_log, ours_log = _plans(monkeypatch, jfew, few_shot,
                               lambda m: m.run_few_shot(ds, cfgs[m], train_sizes=(1, 3), repeats=2))
    assert ours_log == ref_log and len(ours_log) == 2 * 2 * 4  # per repeat: val, 2 epochs' train, test
    pool, val, test = few_shot.few_shot_splits(ds.names)
    assert sorted(pool + val + test) == sorted(ds.names) and ours_log[0] == val and ours_log[-1] == test


# --------------------------------------------------------------------------
# The experiments from the same weights, at max_epochs=0 (initial weights only)
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """Six single-stream 2 s songs (126 frames, one 128-frame bucket), built
    once by the port on the CPU and handed to both packages as the same
    arrays."""
    ds = build_synthetic(n_songs=6, duration_s=2.0, seed=5, two_stream=False, device="cpu")
    jds = JBeatDataset([JSongRecord(r.name, r.vqt, r.pulse, r.down_pulse, r.beat_times, r.downbeat_times)
                        for r in ds])
    return ds, jds


@pytest.fixture(scope="module")
def vanilla_params(corpus):
    state = jsup.init_state(jsup.SupervisedConfig(), corpus[1][0], jax.random.PRNGKey(3))
    return jax.tree_util.tree_map(np.asarray, state.params)


def test_cross_experiment_from_the_same_weights_equals_jax(corpus, vanilla_params):
    ds, jds = corpus
    kw = dict(n_folds=2, max_epochs=0, batch_size=4, eval_method="dbn", seed=1)
    ours = cross.run_cross_experiment(BeatDataset(ds.records[:4]), BeatDataset(ds.records[4:]),
                                      BeatExperimentConfig(**kw), init_params=vanilla_params, device="cpu")
    ref = jcross.run_cross_experiment(JBeatDataset(jds.records[:4]), JBeatDataset(jds.records[4:]),
                                      JBeatConfig(**kw), init_params=vanilla_params)
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        assert a.epochs_run == b.epochs_run == 0
        np.testing.assert_allclose(a.test_metrics[0], b.test_metrics[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.best_val_f1, b.best_val_f1, rtol=0, atol=1e-6)


def test_few_shot_from_the_same_weights_equals_jax(corpus, vanilla_params):
    ds, jds = corpus
    kw = dict(max_epochs=0, batch_size=4, eval_method="dbn", seed=2)
    done = []
    ours = few_shot.run_few_shot(ds, BeatExperimentConfig(**kw), train_sizes=(1, 2), repeats=1,
                                 init_params=vanilla_params, on_size_done=lambda s, r: done.append(s),
                                 device="cpu")
    ref = jfew.run_few_shot(jds, JBeatConfig(**kw), train_sizes=(1, 2), repeats=1, init_params=vanilla_params)
    assert done == [1, 2] and set(ours) == set(ref) == {1, 2}
    for size in ours:
        np.testing.assert_allclose(ours[size]["F1"], ref[size]["F1"], rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# Measures
# --------------------------------------------------------------------------


def test_measures_math_equals_jax():
    rng = np.random.default_rng(7)
    t = np.arange(700)
    pulse = np.clip(0.1 * np.abs(rng.standard_normal(700)) + (t % 29 == 0) * 0.8, 0, 1)
    ours, ref = measures.embedding_measures(pulse), jmeasures.embedding_measures(pulse)
    assert set(ours) == set(ref) == set(measures.MEASURES)
    for k in ours:
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-12, err_msg=k)
    rows = [measures.embedding_measures(np.abs(rng.standard_normal(300))) for _ in range(4)]
    assert measures.quantile_table(rows) == jmeasures.quantile_table(rows)
    assert measures.gini(np.ones(100)) < 0.02 and measures.max_beat_autocorrelation((t % 31 == 0) * 1.0) > 0.8


def test_measures_report_equals_jax(tmp_path):
    rng = np.random.default_rng(8)
    table = measures.quantile_table([measures.embedding_measures(np.abs(rng.standard_normal(200)))
                                     for _ in range(3)])
    for mod, out in ((measures, str(tmp_path / "ours" / "m")), (jmeasures, str(tmp_path / "ref" / "m"))):
        mod.write_measures_report(table, out, "van", run_id="r1", fresh=True)
        mod.write_measures_report(table, out, "rand", run_id="r1")
        mod.write_measures_report(table, out, "bock", run_id="r2")
    ours, ref = str(tmp_path / "ours" / "m"), str(tmp_path / "ref" / "m")
    with open(ours + ".json") as a, open(ref + ".json") as b:
        doc = json.load(a)
        assert doc == json.load(b)
    assert doc["run_id"] == "r2" and set(doc["previous_runs"]["r1"]) == {"van", "rand"}
    with open(ours + ".csv") as a, open(ref + ".csv") as b:
        assert list(csv.reader(a)) == list(csv.reader(b))
    assert read_xlsx(ours + ".xlsx") == j_read_xlsx(ref + ".xlsx")


@pytest.fixture(scope="module")
def twin_corpus():
    ds = build_synthetic(n_songs=2, duration_s=2.0, seed=4, two_stream=True, device="cpu")
    jds = JBeatDataset([JSongRecord(r.name, r.vqt, r.pulse, r.down_pulse, r.beat_times, r.downbeat_times)
                        for r in ds])
    return ds, jds


@pytest.mark.parametrize("status,stream", [("vanilla", "fused"), ("bock", "fused"), ("pretrained", "anchor"),
                                           ("pretrained", "positive")])
def test_measure_arm_equals_jax(corpus, twin_corpus, status, stream):
    ds, jds = twin_corpus if status == "pretrained" else corpus
    state = jsup.init_state(jsup.SupervisedConfig(status=status), jds[0], jax.random.PRNGKey(5))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    ours = measures.measure_arm(ds, status, params, stream=stream, device="cpu")
    ref = jmeasures.measure_arm(jds, status, params, stream=stream)
    assert set(ours) == set(ref)
    for name in SMOOTH:
        for q in ours[name]:
            np.testing.assert_allclose(ours[name][q], ref[name][q], rtol=1e-4, atol=1e-12, err_msg=f"{name} {q}")


def test_measure_arm_needs_a_card_unless_asked_for_cpu(corpus):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        measures.measure_arm(corpus[0], "vanilla")
    with pytest.raises(RuntimeError, match="cuda"):
        cross.run_cross_experiment(corpus[0], corpus[0], BeatExperimentConfig(n_folds=2, max_epochs=0))


# --------------------------------------------------------------------------
# The CLI on the CPU
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cached(tmp_path_factory, corpus):
    root = tmp_path_factory.mktemp("cli")
    train, test = str(root / "train"), str(root / "test")
    BeatDataset(corpus[0].records[:4]).save(train)
    BeatDataset(corpus[0].records[4:]).save(test)
    return root, train, test


def _results(path):
    with open(path) as fh:
        return json.load(fh)


def test_cli_cross_and_few_shot_on_cpu(cached):
    """Both with the small BockTCN, which keeps the CPU run short."""
    root, train, test = cached
    out = str(root / "cross.json")
    cli.main(["cross", "--train-data", train, "--test-data", test, "--status", "bock", "--folds", "2",
              "--max-epochs", "1", "--batch-size", "2", "--lr", "2e-4", "--eval", "threshold", "--device", "cpu",
              "--out", out])
    res = _results(out)
    assert set(res) == set(METRICS) | {m + "_std" for m in METRICS} and all(np.isfinite(list(res.values())))
    out = str(root / "few.json")
    cli.main(["few-shot", "--data", train, "--status", "bock", "--sizes", "1,2", "--repeats", "1",
              "--max-epochs", "1", "--batch-size", "2", "--device", "cpu", "--out", out])
    res = _results(out)
    assert set(res) == {"1", "2"} and all(np.isfinite(v["F1"]) for v in res.values())


def test_cli_measures_on_cpu(cached, twin_corpus, capsys, monkeypatch):
    root, train, _ = cached
    out = str(root / "meas")
    cli.main(["measures", "--data", train, "--status", "van", "--device", "cpu", "--out", out])
    table = json.loads(capsys.readouterr().out)
    assert set(table) == set(measures.MEASURES)
    cli.main(["measures", "--data", train, "--status", "bock", "--model", "bock", "--device", "cpu", "--out", out])
    capsys.readouterr()
    assert set(_results(out + ".json")["arms"]) == {"van", "bock"}

    twin = str(root / "twin")
    twin_corpus[0].save(twin)
    params = str(root / "twin.npz")
    save_params(params, BeatTracker(seed=1, device="cpu").model)
    cli.main(["measures", "--data", twin, "--status", "ros", "--stream", "anchor", "--params", params,
              "--device", "cpu", "--out", out])
    assert set(json.loads(capsys.readouterr().out)) == set(measures.MEASURES)

    # --status std validates at the reference's batch 16 x 313 crops; a CPU
    # run takes batch 4 x 16 from a 40-frame bank item.
    from zeronotesamba_torch.train import pretext

    monkeypatch.setattr(pretext, "PretextConfig", functools.partial(pretext.PretextConfig, batch_size=4,
                                                                    crop_frames=16))
    bank = str(root / "bank.npz")
    rng = np.random.default_rng(0)
    np.savez(bank, val_bank=(rng.standard_normal((1, 2, 96, 40)) - 6).astype(np.float32))
    cli.main(["measures", "--status", "std", "--bank", bank, "--params", params, "--device", "cpu", "--out", out])
    std = json.loads(capsys.readouterr().out)
    assert set(std) == {"val_loss", "pos_sim", "neg_sim"} and np.isfinite(std["val_loss"])
    assert _results(out + "_std.json") == std
    with pytest.raises(SystemExit):
        cli.main(["measures", "--status", "std", "--device", "cpu"])


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    """Three 6 s click tracks as wavs, with a dataset cache of their beats
    whose song names are the wav file names, and two 2 s click tracks in a
    subdirectory."""
    root = tmp_path_factory.mktemp("wavs")
    audio = root / "audio"
    (audio / "short").mkdir(parents=True)
    records = []
    for i, bpm in enumerate((100.0, 120.0, 140.0)):
        sig, beats = click_track(6.0, bpm, seed=20 + i)
        name = f"click_{i}.wav"
        audio_io.write_wav(str(audio / name), sig, 16000)
        records.append(SongRecord(name, np.zeros((1, 96, 8), np.float32), np.zeros(8), np.zeros(8), beats,
                                  np.zeros(0)))
    for i, bpm in enumerate((90.0, 150.0)):
        audio_io.write_wav(str(audio / "short" / f"short_{i}.wav"), click_track(2.0, bpm, seed=30 + i)[0], 16000)
    BeatDataset(records).save(str(root / "cache"))
    return root


def test_cli_old_school_on_cpu(wav_dir, capsys):
    cli.main(["old-school", "--data", str(wav_dir / "cache"), "--audio-root", str(wav_dir / "audio")])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines] == list(METRICS)
    assert float(lines[0].split()[3]) > 0.8  # mean F1 of the Ellis DP on click tracks
    with pytest.raises(SystemExit):
        cli.main(["old-school", "--data", str(wav_dir / "cache"), "--audio-root", str(wav_dir)])


def test_cli_resave_on_cpu(wav_dir, tmp_path, capsys):
    out = tmp_path / "44k"
    cli.main(["resave", str(wav_dir / "audio"), "--out", str(out), "--rate", "44100"])
    assert "resaved 5 files at 44100 Hz" in capsys.readouterr().out
    sig, sr = audio_io.read_wav(str(out / "short" / "short_1.wav"))
    assert sr == 44100 and sig.shape[0] == 2 * 44100
    ref, _ = audio_io.load_audio(str(wav_dir / "audio" / "click_1.wav"), target_sr=44100)
    audio_io.write_wav(str(tmp_path / "ref.wav"), ref, 44100)
    assert (out / "click_1.wav").read_bytes() == (tmp_path / "ref.wav").read_bytes()


@pytest.mark.parametrize("decoder", ["dbn", "librosa"])
def test_cli_track_dir_on_cpu(wav_dir, tmp_path, decoder):
    params = str(tmp_path / "w.npz")
    tracker = BeatTracker(seed=2, device="cpu")
    save_params(params, tracker.model)
    out = str(tmp_path / "beats.json")
    cli.main(["track-dir", str(wav_dir / "audio" / "short"), "--params", params, "--separation", "mix",
              "--decoder", decoder, "--device", "cpu", "--out", out])
    res = _results(out)
    assert sorted(res) == ["short_0.wav", "short_1.wav"]
    ref = tracker.track_file(str(wav_dir / "audio" / "short" / "short_1.wav"), separation="mix", decoder=decoder)
    assert res["short_1.wav"] == [float(t) for t in ref.beat_times]


def test_cli_learned_separation_on_cpu(wav_dir, tmp_path, capsys):
    """infer and track-dir with --separation learned, on the shipped separator
    by default, against the in-process tracker; an orbax directory as
    --sep-model is refused per file, naming the exporter."""
    wav = str(wav_dir / "audio" / "click_0.wav")
    params = str(tmp_path / "w.npz")
    tracker = BeatTracker(seed=4, device="cpu")
    save_params(params, tracker.model)
    ref = tracker.track_file(wav, separation="learned", sep_model=SEPARATOR_NPZ, decoder="dbn")
    cli.main(["infer", wav, "--params", params, "--separation", "learned", "--device", "cpu"])
    payload = json.loads(capsys.readouterr().out)
    assert payload == {"n_frames": ref.fused_pulse.shape[0], "beat_times": [float(t) for t in ref.beat_times]}

    out = str(tmp_path / "beats.json")
    short = str(wav_dir / "audio" / "short")
    cli.main(["track-dir", short, "--params", params, "--separation", "learned", "--sep-model", SEPARATOR_NPZ,
              "--device", "cpu", "--out", out])
    res = _results(out)
    ref = tracker.track_file(os.path.join(short, "short_0.wav"), separation="learned", sep_model=SEPARATOR_NPZ)
    assert sorted(res) == ["short_0.wav", "short_1.wav"] and res["short_0.wav"] == [float(t) for t in ref.beat_times]
    cli.main(["track-dir", short, "--separation", "learned", "--sep-model", os.path.join(ROOT, "models", "separator"),
              "--device", "cpu", "--out", out])
    assert all("test_torch_separator_export" in v["error"] for v in _results(out).values())
