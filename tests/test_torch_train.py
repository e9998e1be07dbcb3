"""The port's training path against the JAX package's: optimizer rules, the
train step from transplanted weights, the epoch loop, checkpoints, the fold
splits, the experiment and the build-data / beat CLI.

Tolerances: lr rules exact; Adam against optax.adam rtol 1e-6 over 5 steps;
one train_step at dropout off from the same weights: loss 1e-5 relative,
gradients per tensor within 1e-4 of that tensor's largest |g|, outputs 2e-5,
new parameters within 2 lr (Adam's first step moves a weight by at most lr);
fold splits, the frozen trunk, steps_per_call, repeat and resume runs exact;
early stopping keeps the initial weights of a fold that never improves.

The gradient tolerance holds while both packages route every max-pool
window's gradient to the same input. Where a window's two largest inputs lie
within float32 rounding of each other, either package may pick the other,
and every gradient below that pool moves by about 4e-3 of its largest: of
twelve (data seed, init key, model) draws at this size, three gave such a
flip and the rest agreed to 1.8e-6 to 8.4e-6 of the largest. The draw here
(data seed 12, init key 4) has none, for both models.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from zeronotesamba_tpu.data.datasets import SongRecord as JSongRecord
from zeronotesamba_tpu.experiments.beat import _folds as j_folds
from zeronotesamba_tpu.train import state as jstate
from zeronotesamba_tpu.train import supervised as jsup
from zeronotesamba_torch import cli
from zeronotesamba_torch.data.datasets import BeatDataset, build_synthetic
from zeronotesamba_torch.data.pulse import beat_pulse
from zeronotesamba_torch.experiments.beat import (
    BeatExperimentConfig,
    _folds,
    run_beat_experiment,
    summarize,
    summarize_extra,
)
from zeronotesamba_torch.infer import BeatTracker
from zeronotesamba_torch.models.encoder import DSCNN, FusedDownstream
from zeronotesamba_torch.models.weights import state_dict_from_jax
from zeronotesamba_torch.train.checkpoint import CheckpointManager, load_params, save_params
from zeronotesamba_torch.train.state import (
    downstream_learning_rate,
    make_optimizer,
    pretext_learning_rate,
)
from zeronotesamba_torch.train.supervised import (
    StagedDataset,
    SupervisedConfig,
    eval_step,
    init_state,
    make_model,
    run_epoch,
    train_step,
)

torch.set_num_threads(2)

B, T = 2, 64
LR = 1e-4
TINY_FRAMES = 32
METRICS = ("F1", "CMLc", "CMLt", "AMLc", "AMLt", "InfoGain")


@pytest.mark.parametrize("status", ["vanilla", "pretrained", "clmr", "bock"])
@pytest.mark.parametrize("pre", ["finetune", "frozen"])
def test_lr_rules_match_jax(status, pre):
    for lr in (1e-5, 2e-4):
        assert downstream_learning_rate(status, pre, lr) == jstate.downstream_learning_rate(status, pre, lr)
    assert downstream_learning_rate("pretrained", "finetune", 1e-5) == 0.5 * 1e-5 * 10e-2


def test_pretext_lr_rule():
    assert pretext_learning_rate("zerons") == 1e-6 and pretext_learning_rate("clmr") == 1e-5
    assert pretext_learning_rate("zerons", 3e-4) == 3e-4


@pytest.mark.parametrize("status", ["vanilla", "pretrained"])
def test_adam_matches_optax(status):
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) * 10.0 ** -k for k in range(5)]
    model = torch.nn.Module()
    model.w = torch.nn.Parameter(torch.tensor(w0))
    opt = make_optimizer(model, status, "finetune", 1e-3)
    tx = optax.adam(jstate.downstream_learning_rate(status, "finetune", 1e-3), b1=0.9, b2=0.999)
    params, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(params)
    for g in grads:
        model.w.grad = torch.tensor(g)
        opt.step()
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(model.w.detach().numpy(), np.asarray(params), rtol=1e-6)


def test_frozen_trunk_optimizer_holds_only_the_heads():
    fused = FusedDownstream()
    names = {id(p): n for n, p in fused.named_parameters()}
    held = [names[id(p)] for g in make_optimizer(fused, "pretrained", "frozen", 1e-3).param_groups for p in g["params"]]
    assert sorted(held) == sorted(f"pretext.{s}.fc1.{t}" for s in ("anchor", "postve") for t in ("weight", "bias"))
    held = make_optimizer(DSCNN(), "clmr", "frozen", 1e-3).param_groups[0]["params"]
    assert len(held) == 2
    assert len(make_optimizer(DSCNN(), "vanilla", "frozen", 1e-3).param_groups[0]["params"]) == 18


def test_bock_is_not_ported():
    """Status 'bock' builds the BockTCN baseline (models/baseline.py) in the
    compute dtype asked for, and its optimizer holds every parameter at the
    plain lr, frozen or not; an unknown compute dtype raises."""
    from zeronotesamba_torch.models.baseline import BockTCN

    model = make_model("bock")
    assert isinstance(model, BockTCN) and model.compute_dtype == torch.float32
    assert make_model("bock", "bfloat16").compute_dtype == torch.bfloat16
    for pre in ("finetune", "frozen"):
        (group,) = make_optimizer(model, "bock", pre, 1e-3).param_groups
        assert len(group["params"]) == len(list(model.parameters())) and group["lr"] == 1e-3
    with pytest.raises(KeyError):
        make_model("bock", "float16")


def _example(t):
    return JSongRecord("x", np.zeros((2, 96, t), np.float32), np.zeros(t, np.float32), np.zeros(t, np.float32),
                       np.zeros(1), np.zeros(0))


@pytest.fixture(scope="module")
def step_inputs():
    rng = np.random.default_rng(12)
    vqt = (rng.standard_normal((B, 2, 96, T)) * 4.0 - 6.0).astype(np.float32)
    pulse = np.stack([beat_pulse(np.sort(rng.uniform(0, T / 62.5, 3)), T) for _ in range(B)])
    mask = np.ones((B, T), np.float32)
    mask[1, 50:] = 0.0
    pulse[1, 50:] = 0.0
    return vqt, pulse, mask


@pytest.fixture(scope="module", params=["vanilla", "pretrained"])
def jax_step(request, step_inputs):
    """The JAX package's train step at dropout off (dropout_rng=None) from
    its own init, with its gradients; everything as numpy."""
    status = request.param
    cfg = jsup.SupervisedConfig(status=status, lr=LR, bucket_frames=T)
    state = jsup.init_state(cfg, _example(T), jax.random.PRNGKey(4))
    params = jax.tree_util.tree_map(np.asarray, state.params)
    vqt, pulse, mask = (jnp.asarray(x) for x in step_inputs)

    def loss_fn(p):
        return jsup._loss_and_out(state.apply_fn, p, vqt, pulse, mask, None, status, 1.0)[0]

    grads = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss_fn))(state.params))
    new_state, loss, out = jsup.train_step(state, vqt, pulse, mask, None, status)
    return dict(status=status, params=params, grads=grads, loss=float(loss), out=np.asarray(out),
                new_params=jax.tree_util.tree_map(np.asarray, new_state.params))


def test_train_step_matches_jax(jax_step, step_inputs):
    status = jax_step["status"]
    cfg = SupervisedConfig(status=status, lr=LR, bucket_frames=T)
    state = init_state(cfg, None, 0, params=jax_step["params"], device="cpu")
    start = state_dict_from_jax(jax_step["params"])
    assert all(torch.equal(v, start[k]) for k, v in state.model.state_dict().items())
    state, loss, out = train_step(state, *(torch.tensor(x) for x in step_inputs), None, status)
    assert state.step == 1 and not state.model.training
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), jax_step["out"], atol=2e-5)
    ref_grads = state_dict_from_jax(jax_step["grads"])
    new = state_dict_from_jax(jax_step["new_params"])
    lr = downstream_learning_rate(status, "finetune", LR)
    for name, p in state.model.named_parameters():
        g_ref = ref_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), g_ref.numpy(), rtol=0, atol=1e-4 * g_ref.abs().max().item(),
                                   err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), new[name].numpy(), rtol=0, atol=2 * lr, err_msg=name)
        assert not torch.equal(p.detach(), start[name]), f"{name} did not move"


def test_eval_step_matches_train_step_outputs(jax_step, step_inputs):
    status = jax_step["status"]
    state = init_state(SupervisedConfig(status=status), None, 0, params=jax_step["params"], device="cpu")
    loss, out = eval_step(state, *(torch.tensor(x) for x in step_inputs), status)
    np.testing.assert_allclose(loss.item(), jax_step["loss"], rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), jax_step["out"], atol=2e-5)


@pytest.fixture(scope="module")
def tiny():
    """Four 0.5 s songs of one beat each (32 frames, one bucket at
    bucket_frames TINY_FRAMES)."""
    return build_synthetic(n_songs=4, duration_s=0.5, seed=3, device="cpu")


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def _epochs(tiny, cfg, epochs, seed=0, state=None, start=0, n_songs=1):
    staged = StagedDataset(tiny.records, cfg.bucket_frames, device="cpu")
    plan = staged.plan(tiny.names[:n_songs], cfg.batch_size)
    state = state or init_state(cfg, tiny[0], seed, device="cpu")
    losses = []
    for e in range(start, start + epochs):
        state, loss, metrics = run_epoch(state, staged, plan, cfg, train=True, epoch=e, score=True)
        losses.append(loss)
    return state, losses, metrics


def test_frozen_trunk_is_bit_identical_after_an_epoch(tiny):
    cfg = SupervisedConfig(status="pretrained", pre="frozen", lr=1e-3, batch_size=4, bucket_frames=TINY_FRAMES)
    state = init_state(cfg, tiny[0], 2, device="cpu")
    before = _params(state)
    state, losses, metrics = _epochs(tiny, cfg, 1, state=state)
    assert state.step == 1 and np.isfinite(losses[0]) and metrics.shape == (6,)
    after = _params(state)
    for k in before:
        if ".pretrained." in k:
            assert torch.equal(before[k], after[k]), k
        else:
            assert not torch.equal(before[k], after[k]), f"head {k} did not move"


def test_steps_per_call_equals_sequential_steps(tiny):
    """steps_per_call is the JAX engine's dispatch option: K = 2 trains the
    two full batches in one call (the plain two-step loop on the CPU), the
    same two sequential steps."""
    runs = {}
    for k in (1, 2):
        cfg = SupervisedConfig(status="vanilla", lr=2e-4, batch_size=1, bucket_frames=TINY_FRAMES, steps_per_call=k)
        state, losses, metrics = _epochs(tiny, cfg, 1, n_songs=2)
        runs[k] = (losses, metrics, _params(state), state.step)
    assert runs[1][0] == runs[2][0] and runs[1][3] == runs[2][3] == 2
    np.testing.assert_array_equal(runs[1][1], runs[2][1])
    assert all(torch.equal(runs[1][2][n], runs[2][2][n]) for n in runs[1][2])


def test_seeded_dropout_repeats_exactly(tiny):
    """Dropout on: the same dropout_seed repeats the run; another differs."""
    out = []
    for seed in (0, 0, 1):
        cfg = SupervisedConfig(status="vanilla", lr=2e-4, batch_size=4, bucket_frames=TINY_FRAMES, dropout_seed=seed)
        out.append(_epochs(tiny, cfg, 1)[1][0])
    assert out[0] == out[1] != out[2]


def test_checkpoint_resume_equals_an_uninterrupted_run(tiny, tmp_path):
    cfg = SupervisedConfig(status="vanilla", lr=2e-4, batch_size=4, bucket_frames=TINY_FRAMES)
    whole, whole_losses, _ = _epochs(tiny, cfg, 2)

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=1)
    with pytest.raises(FileNotFoundError):
        mgr.restore(init_state(cfg, tiny[0], 0, device="cpu"))
    first, first_losses, _ = _epochs(tiny, cfg, 1)
    for step in (0, first.step):
        mgr.save(step, first, metrics={"loss": np.float32(first_losses[0])})
    assert mgr.latest_step() == first.step == 1
    assert [p.name for p in (tmp_path / "ckpt").iterdir()] == ["ckpt_1.pt"]  # the newest max_to_keep
    mgr.close()

    resumed = CheckpointManager(str(tmp_path / "ckpt")).restore(init_state(cfg, tiny[0], 99, device="cpu"))
    assert resumed.step == first.step
    resumed, rest_losses, _ = _epochs(tiny, cfg, 1, state=resumed, start=1)
    assert first_losses + rest_losses == whole_losses
    ours, ref = _params(resumed), _params(whole)
    assert all(torch.equal(ours[k], ref[k]) for k in ref)
    saved = torch.load(str(tmp_path / "ckpt" / f"ckpt_{first.step}.pt"), weights_only=True)
    assert saved["metrics"] == {"loss": pytest.approx(first_losses[0])}


@pytest.fixture(scope="module")
def fused():
    return init_state(SupervisedConfig(status="pretrained"), None, 5, device="cpu").model


@pytest.mark.parametrize("suffix", [".pth", ".npz"])
def test_save_params_loads_into_infer_and_the_trainer(tmp_path, suffix, fused):
    path = str(tmp_path / f"best{suffix}")
    save_params(path, fused)
    sd = load_params(path)
    assert all(k.startswith(("anchor.", "postve.")) for k in sd)  # the reference Pretext_CNN keys
    tracker = BeatTracker(sd, device="cpu")
    assert all(torch.equal(v, fused.pretext.state_dict()[k]) for k, v in tracker.state_dict().items())
    again = init_state(SupervisedConfig(status="pretrained"), None, 0, params=sd, device="cpu").model
    assert all(torch.equal(v, fused.state_dict()[k]) for k, v in again.state_dict().items())


def test_save_params_of_a_single_stream_model(tmp_path):
    single = init_state(SupervisedConfig(status="vanilla"), None, 5, device="cpu").model
    save_params(str(tmp_path / "best.pth"), single)
    sd = load_params(str(tmp_path / "best.pth"))
    assert list(sd) == list(single.state_dict())  # the reference DS_CNN keys
    assert all(torch.equal(v, single.state_dict()[k]) for k, v in sd.items())
    with pytest.raises(ValueError):
        save_params(str(tmp_path / "best.ckpt"), single)


@pytest.mark.parametrize("n,folds,seed", [(16, 4, 0), (10, 8, 3), (7, 2, 11)])
def test_folds_equal_jax(n, folds, seed):
    import random

    names = [f"song{i}" for i in range(n)]
    ours, ref = random.Random(seed), random.Random(seed)
    assert _folds(names, folds, ours) == j_folds(names, folds, ref)
    assert ours.random() == ref.random()  # the rng left in the same state


def test_experiment_runs_two_folds_with_threshold_decoder(tiny):
    cfg = BeatExperimentConfig(status="vanilla", lr=2e-4, eval_method="threshold", n_folds=2, max_epochs=1,
                               batch_size=2, bucket_frames=TINY_FRAMES, return_params=True, extra_eval_methods=("dbn",))
    results = run_beat_experiment(tiny, cfg, device="cpu", progress=False)
    assert [r.fold for r in results] == [0, 1] and all(r.epochs_run == 1 for r in results)
    for r in results:
        assert r.test_metrics.shape == (6,) and np.isfinite(r.test_metrics).all() and r.seconds > 0
        assert r.extra_metrics["dbn"].shape == (6,)
        assert set(r.best_params) == set(DSCNN().state_dict())
    summary = summarize(results)
    assert set(summary) == set(METRICS) | {m + "_std" for m in METRICS}
    extra = summarize_extra(results)
    assert set(extra) == {"dbn"} and set(extra["dbn"]) == set(summary)
    assert extra["dbn"]["F1"] == np.mean([r.extra_metrics["dbn"][0] for r in results])


def test_early_stopping_ends_a_fold_that_does_not_improve(tiny):
    """At lr 0 the weights never move, so validation F1 never beats the
    initial candidate: patience 1 stops each fold after one epoch and keeps
    the initial weights."""
    cfg = BeatExperimentConfig(status="vanilla", lr=0.0, eval_method="threshold", n_folds=2, max_epochs=5,
                               patience=1, batch_size=2, bucket_frames=TINY_FRAMES, return_params=True)
    results = run_beat_experiment(tiny, cfg, device="cpu", progress=False)
    for r in results:
        init = init_state(SupervisedConfig(status="vanilla"), None, cfg.seed + r.fold, device="cpu").model
        assert r.epochs_run == 1
        assert all(torch.equal(v, init.state_dict()[k]) for k, v in r.best_params.items())


def test_zero_shot_experiment_evaluates_given_params(tiny):
    fused = FusedDownstream()
    cfg = BeatExperimentConfig(status="pretrained", pre="validation", eval_method="threshold", batch_size=4,
                               bucket_frames=TINY_FRAMES, return_params=True)
    (res,) = run_beat_experiment(tiny, cfg, init_params=fused.pretext.state_dict(), device="cpu")
    assert res.epochs_run == 0 and res.test_metrics.shape == (6,)
    assert all(torch.equal(v, fused.state_dict()[k]) for k, v in res.best_params.items())


def test_cli_build_data_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "synth")
    cli.main(["build-data", "synthetic", "--out", out, "--n-songs", "2", "--device", "cpu"])
    assert "saved 2 songs" in capsys.readouterr().out
    got, ref = BeatDataset.load(out), build_synthetic(n_songs=2, device="cpu")
    assert got.names == ref.names
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.vqt, b.vqt)
        np.testing.assert_array_equal(a.pulse, b.pulse)


def test_cli_beat_on_cpu(tiny, tmp_path):
    data, out = str(tmp_path / "tiny"), str(tmp_path / "beat.json")
    tiny.save(data)
    cli.main(["beat", "--data", data, "--folds", "2", "--max-epochs", "1", "--batch-size", "2", "--lr", "2e-4",
              "--eval", "threshold", "--steps-per-call", "2", "--device", "cpu", "--out", out])
    with open(out) as fh:
        res = json.load(fh)
    assert set(res) == set(METRICS) | {m + "_std" for m in METRICS}
    assert all(np.isfinite(v) for v in res.values())

    # Zero-shot from a weights file in the reference key names.
    params = str(tmp_path / "w.npz")
    save_params(params, FusedDownstream())
    cli.main(["beat", "--data", data, "--status", "pretrained", "--pre", "validation", "--params", params,
              "--eval", "threshold", "--device", "cpu", "--out", out])
    with open(out) as fh:
        assert json.load(fh)["F1_std"] == 0.0  # one result


def test_training_entry_points_need_a_card_unless_asked_for_cpu(tiny, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the CUDA default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["build-data", "synthetic", "--out", str(tmp_path / "d"), "--n-songs", "1"])
    tiny.save(str(tmp_path / "tiny"))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["beat", "--data", str(tmp_path / "tiny"), "--folds", "2", "--max-epochs", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        init_state(SupervisedConfig(), None, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        StagedDataset(tiny.records, 64)
