"""The port's mesh over its time and model axes against the JAX package's:
``spectrogram_sharding`` / ``replicated`` / ``shard_params_tp`` placement,
the dp x sp supervised steps, the tensor-parallel ``DSCNN``, the pretext
step on a mixed mesh, and the refusals.

The port's side runs in one world of four gloo ranks on the CPU, spawned
once for the module (``run_ranks``), one thread a rank; every rank-side
check runs there and returns numpy results. The JAX references run in this
process on conftest's eight CPU devices. JAX is imported only inside the
reference helpers, so the spawned ranks, which import this module to find
their function, do not load it.

A sharded conv sums in another order than the whole one, so a max-pool
window whose two largest inputs lie within float32 rounding, or a ReLU
input within rounding of 0, can decide otherwise on a rank and move a
tensor's gradient by about 1e-2 of its largest. The sharded train steps
therefore replay the single-device step's decisions, each rank its share
of them (``utils/parity.PiecewiseDecisions.shard``), so both backward passes
follow one linear piece and the gradients differ by rounding alone.

Tolerances:
- placement: the rows, frames and channels each rank holds equal the JAX
  NamedSharding's ``devices_indices_map`` on the same mesh shape, exactly;
- dp x sp at (2, 2, 1), FusedDownstream from JAX params, B = 4, T = 64,
  ragged mask: the eval loss and outputs against JAX ``eval_step`` 1e-5
  relative (outputs: of their largest); the train step at dropout 0 against
  the port's single-device step: loss 1e-5 relative, gradients 1e-3 of each
  tensor's largest, parameters 2 lr plus float32 rounding;
- TP at (1, 1, 4): the ``DSCNN`` forward against JAX ``DSCNN.apply`` at
  rtol 1e-4 and atol 1e-5, and a TP train step's gathered gradients against
  the single-device step's within 1e-3 of their largest (an m-fold gradient
  fails it by far), its gathered parameters 2 lr plus rounding;
- the pretext step at (1, 2, 2): the loss against JAX ``make_train_step``
  on one device, 1e-4 relative.
"""

import numpy as np
import pytest
import torch

from zeronotesamba_torch.models.encoder import DSCNN
from zeronotesamba_torch.models.weights import load_weights, state_dict_from_jax
from zeronotesamba_torch.parallel import mesh as pmesh
from zeronotesamba_torch.parallel.launch import run_ranks
from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_train_step
from zeronotesamba_torch.train.state import downstream_learning_rate
from zeronotesamba_torch.train.supervised import SupervisedConfig, eval_step, init_state, train_step
from zeronotesamba_torch.utils.parity import PiecewiseDecisions

torch.set_num_threads(2)

WORLD = 4
B, T = 4, 64  # dp x sp songs and frames
TP_B, TP_T = 2, 32
PRE_B, CROP = 2, 16
LR = 1e-3
EPS = float(np.finfo(np.float32).eps)
PLACEMENT_SHAPES = ((2, 2, 1), (1, 1, 4), (1, 2, 2), (4, 1, 1), (1, 4, 1))


def _sup_inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    vqt = (rng.standard_normal((b, 2, 96, t)) * 4.0 - 6.0).astype(np.float32)
    pulse = (rng.uniform(size=(b, t)) < 0.1).astype(np.float32)
    mask = np.ones((b, t), np.float32)
    mask[1, t - 21:] = 0.0  # ragged: song 1 ends inside the second time shard
    mask[-1, t // 2 - 5:] = 0.0  # and the last song inside the first
    pulse *= mask
    return vqt, pulse, mask


def _np(d: dict) -> dict:
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _grads(model) -> dict:
    return {k: p.grad for k, p in model.named_parameters()}


def _sup_step(mesh, status, params, arrays, decisions, tp: bool):
    """eval_step and one train_step (dropout 0) of ``status`` on ``mesh``,
    the train step replaying this rank's share of ``decisions``."""
    state = init_state(SupervisedConfig(status=status, lr=LR), None, 0, params=params, device="cpu")
    if tp:
        pmesh.shard_params_tp(mesh, state.model)
    place = pmesh.spectrogram_sharding(mesh)
    vqt, pulse, mask = (place(a) for a in arrays)
    eloss, eout = eval_step(state, vqt, pulse, mask, status, mesh=mesh)
    with decisions.shard(mesh).replay():
        state, loss, _ = train_step(state, vqt, pulse, mask, None, status, mesh=mesh)
    return dict(eval_loss=eloss.item(), eval_out=eout.numpy(), loss=loss.item(),
                grads=_np(pmesh.gather_tp(mesh, state.model, _grads(state.model))),
                params=_np(pmesh.gather_params_tp(mesh, state.model)))


def _refusal(call):
    try:
        call()
    except ValueError as e:
        return str(e)
    return None


def _rank_checks(world_mesh, inp):
    torch.set_num_threads(1)
    out = {"placement": {}}
    g4 = np.arange(B * 2 * 96 * T, dtype=np.float32).reshape(B, 2, 96, T)
    g2 = np.arange(B * T, dtype=np.float32).reshape(B, T)
    for shape in PLACEMENT_SHAPES:
        mesh = pmesh.make_mesh(*shape)
        model = DSCNN()
        load_weights(model, inp["dscnn"])
        pmesh.shard_params_tp(mesh, model)
        out["placement"][shape] = dict(
            coords=mesh.coords, spec=pmesh.spectrogram_sharding(mesh)(g4).numpy(),
            pulse=pmesh.spectrogram_sharding(mesh)(g2).numpy(), rep=pmesh.replicated(mesh)(g2).numpy(),
            params=_np(model.state_dict()), sharded=sorted(model.tp_sharded),
            whole=_np(pmesh.gather_params_tp(mesh, model)))

    mesh = pmesh.make_mesh(2, 2, 1)
    out["dp_sp"] = _sup_step(mesh, "pretrained", inp["fused"], inp["sup"], inp["sup_decisions"], tp=False)
    out["refuse_frames_split"] = _refusal(lambda: pmesh.spectrogram_sharding(mesh)(np.zeros((2, 2, 96, 63))))
    state = init_state(SupervisedConfig(status="pretrained"), None, 0, params=inp["fused"], device="cpu")
    short = [pmesh.spectrogram_sharding(mesh)(a) for a in _sup_inputs(B, 22, 1)]  # 11 frames a time rank
    out["refuse_short_shard"] = _refusal(lambda: eval_step(state, *short, "pretrained", mesh=mesh))

    mesh = pmesh.make_mesh(1, 1, 4)
    model = DSCNN()
    load_weights(model, inp["dscnn"])
    out["refuse_unsharded"] = _refusal(lambda: model.eval()(torch.tensor(inp["tp_x"]), mesh=mesh))
    pmesh.shard_params_tp(mesh, model)
    with torch.no_grad():
        out["tp_forward"] = model.eval()(pmesh.replicated(mesh)(inp["tp_x"]), mesh=mesh).numpy()
    out["tp_step"] = _sup_step(mesh, "vanilla", inp["dscnn"], inp["tp_sup"], inp["tp_decisions"], tp=True)

    mesh = pmesh.make_mesh(1, 2, 2)
    cfg = PretextConfig(batch_size=PRE_B, crop_frames=CROP, dropout_rate=0.0)
    state = init_pretext_state(cfg, 0, params=inp["twin"], device="cpu")
    state, loss, pc, nc = make_train_step(cfg, mesh)(state, inp["pre_batch"], None)
    out["pretext"] = dict(values=[loss.item(), pc.item(), nc.item()], params=_np(state.model.state_dict()))
    return out


def _jax_params(kind: str, key: int, t: int):
    import jax

    from zeronotesamba_tpu.data.datasets import SongRecord
    from zeronotesamba_tpu.train import pretext as jpre
    from zeronotesamba_tpu.train import supervised as jsup

    if kind == "twin":
        cfg = jpre.PretextConfig(batch_size=PRE_B, crop_frames=CROP, dropout_rate=0.0)
        return jax.tree_util.tree_map(np.asarray, jpre.init_pretext_state(cfg, jax.random.PRNGKey(key)).params)
    example = SongRecord("x", np.zeros((2, 96, t), np.float32), np.zeros(t, np.float32), np.zeros(t, np.float32),
                         np.zeros(1), np.zeros(0))
    state = jsup.init_state(jsup.SupervisedConfig(status=kind, bucket_frames=t), example, jax.random.PRNGKey(key))
    return jax.tree_util.tree_map(np.asarray, state.params)


def _single_step(status, params, arrays):
    """The port's single-device train step (dropout 0), its decisions recorded."""
    decisions = PiecewiseDecisions()
    state = init_state(SupervisedConfig(status=status, lr=LR), None, 0, params=params, device="cpu")
    with decisions.record():
        state, loss, _ = train_step(state, *(torch.tensor(a) for a in arrays), None, status)
    return decisions, dict(loss=loss.item(), grads=_np(_grads(state.model)), params=_np(state.model.state_dict()))


@pytest.fixture(scope="module")
def inputs():
    inp = dict(fused=_jax_params("pretrained", 4, T), dscnn=_jax_params("vanilla", 5, TP_T),
               twin=_jax_params("twin", 1, 0),
               sup=_sup_inputs(B, T, 0), tp_sup=_sup_inputs(TP_B, TP_T, 2),
               tp_x=(np.random.default_rng(3).standard_normal((TP_B, 1, 96, TP_T)) * 4.0 - 6.0).astype(np.float32))
    g = np.random.default_rng(4)
    bank = (g.standard_normal((2, 96, 40)) * 4.0 - 6.0).astype(np.float32)
    inp["pre_batch"] = np.stack([bank[:, :, s: s + CROP] for s in g.choice(40 - CROP + 1, PRE_B, replace=False)])
    return inp


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device supervised steps, with their decisions."""
    return dict(dp_sp=_single_step("pretrained", inputs["fused"], inputs["sup"]),
                tp=_single_step("vanilla", inputs["dscnn"], inputs["tp_sup"]))


@pytest.fixture(scope="module")
def ranks(inputs, single):
    inp = dict(inputs, sup_decisions=single["dp_sp"][0], tp_decisions=single["tp"][0])
    return run_ranks(_rank_checks, WORLD, "gloo", inp, timeout_s=600)


@pytest.mark.parametrize("shape", PLACEMENT_SHAPES)
def test_placement_equals_jax_index_maps(ranks, inputs, shape):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zeronotesamba_tpu.parallel import mesh as jmesh

    jm = jmesh.make_mesh(*shape, devices=jax.devices()[:WORLD])
    g4 = np.arange(B * 2 * 96 * T, dtype=np.float32).reshape(B, 2, 96, T)
    g2 = np.arange(B * T, dtype=np.float32).reshape(B, T)
    nhwc = g4.transpose(0, 2, 3, 1)  # the JAX model's (B, F, T, C)
    spec_maps = (NamedSharding(jm, P("data", None, None, "time")).devices_indices_map(g4.shape),
                 jmesh.spectrogram_sharding(jm).devices_indices_map(nhwc.shape))
    pulse_map = NamedSharding(jm, P("data", "time")).devices_indices_map(g2.shape)
    rep_map = jmesh.replicated(jm).devices_indices_map(g2.shape)
    placed = jmesh.shard_params_tp(jm, inputs["dscnn"])
    whole = state_dict_from_jax(inputs["dscnn"])
    for r, dev in enumerate(jax.devices()[:WORLD]):
        got = ranks[r]["placement"][shape]
        assert tuple(got["coords"].values()) == tuple(int(c) for c in np.argwhere(jm.devices == dev)[0])
        np.testing.assert_array_equal(got["spec"], g4[spec_maps[0][dev]])
        np.testing.assert_array_equal(got["spec"], nhwc[spec_maps[1][dev]].transpose(0, 3, 1, 2))
        np.testing.assert_array_equal(got["pulse"], g2[pulse_map[dev]])
        np.testing.assert_array_equal(got["rep"], g2[rep_map[dev]])
        local = jax.tree_util.tree_map(lambda a: np.asarray(a)[a.sharding.devices_indices_map(a.shape)[dev]], placed)
        for name, v in state_dict_from_jax(local).items():
            np.testing.assert_array_equal(got["params"][name], v.numpy(), err_msg=name)
        for name, v in whole.items():
            np.testing.assert_array_equal(got["whole"][name], v.numpy(), err_msg=name)
        model_axis = shape[2]
        expect = [] if model_axis == 1 else sorted(n for n in whole if n.startswith("pretrained."))
        assert got["sharded"] == expect


def _assert_step_close(got, ref, lr):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for name, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=0, atol=1e-3 * np.abs(g).max(), err_msg=name)
    for name, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][name], v, rtol=2 * EPS, atol=2 * lr, err_msg=name)


def test_dp_sp_eval_matches_jax(ranks, inputs):
    import jax.numpy as jnp

    from zeronotesamba_tpu.train import supervised as jsup

    loss, out = jsup.eval_step(_jax_state("pretrained", inputs["fused"]), *(jnp.asarray(a) for a in inputs["sup"]),
                               "pretrained")
    out = np.asarray(out)
    # The ranks' outputs are (B/2, T/2) blocks, laid out by their coordinates.
    blocks = np.zeros_like(out)
    for r in ranks:
        c, part = r["placement"][(2, 2, 1)]["coords"], r["dp_sp"]["eval_out"]
        blocks[c["data"] * 2: c["data"] * 2 + 2, c["time"] * (T // 2): (c["time"] + 1) * (T // 2)] = part
        np.testing.assert_allclose(r["dp_sp"]["eval_loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(blocks, out, rtol=0, atol=1e-5 * np.abs(out).max())


def _jax_state(status, params):
    from zeronotesamba_tpu.data.datasets import SongRecord
    from zeronotesamba_tpu.train import supervised as jsup

    example = SongRecord("x", np.zeros((2, 96, T), np.float32), np.zeros(T, np.float32), np.zeros(T, np.float32),
                         np.zeros(1), np.zeros(0))
    return jsup.init_state(jsup.SupervisedConfig(status=status, bucket_frames=T), example, None, params=params)


def test_dp_sp_train_step_matches_single_device(ranks, single):
    ref = single["dp_sp"][1]
    lr = downstream_learning_rate("pretrained", "finetune", LR)
    for r in ranks:
        _assert_step_close(r["dp_sp"], ref, lr)


def test_tp_forward_matches_jax(ranks, inputs):
    import jax.numpy as jnp

    from zeronotesamba_tpu.models.encoder import DSCNN as JDSCNN

    x = jnp.asarray(inputs["tp_x"].transpose(0, 2, 3, 1))
    ref = np.asarray(JDSCNN().apply(inputs["dscnn"], x))
    for r in ranks:
        np.testing.assert_allclose(r["tp_forward"], ref, rtol=1e-4, atol=1e-5)


def test_tp_train_step_gathers_the_single_device_gradients(ranks, single):
    ref = single["tp"][1]
    for r in ranks:
        _assert_step_close(r["tp_step"], ref, LR)


def test_mixed_mesh_pretext_loss_matches_jax(ranks, inputs):
    import jax
    import jax.numpy as jnp
    import optax

    from zeronotesamba_tpu.train import pretext as jpre
    from zeronotesamba_tpu.train.state import TrainState

    cfg = jpre.PretextConfig(batch_size=PRE_B, crop_frames=CROP, dropout_rate=0.0)
    state = TrainState.create(apply_fn=jpre.make_pretext_model("zerons", 0.0).apply, params=inputs["twin"],
                              tx=optax.adam(1e-4))
    _, loss, pc, nc = jpre.make_train_step(cfg)(state, jnp.asarray(inputs["pre_batch"]), jax.random.PRNGKey(0))
    for r in ranks:
        np.testing.assert_allclose(r["pretext"]["values"], [float(loss), float(pc), float(nc)], rtol=1e-4)
        for name, v in ranks[0]["pretext"]["params"].items():  # the time and model ranks replicate the step
            np.testing.assert_array_equal(r["pretext"]["params"][name], v, err_msg=name)


def test_refusals(ranks):
    for r in ranks:
        assert "do not split over the 2 ranks of the time axis" in r["refuse_frames_split"]
        assert "11 frames a time rank" in r["refuse_short_shard"]
        assert "shard the parameters with shard_params_tp" in r["refuse_unsharded"]
