"""The port's data-parallel mesh against the JAX package's: ``make_mesh``,
``ntxent_global``, the sharded host-batch step, the track-parallel staged
step, the launcher, rank 0's host array shared by a mapped file and
``pretext --data-parallel``
(tests/test_torch_mesh_driver.py holds ``train_pretext`` under a mesh).

The port's side runs in one world of two gloo ranks on the CPU, spawned
once for the module (``run_ranks``): every rank-side check runs there and
returns numpy results. The JAX references run in this process on a mesh of
two of conftest's eight CPU devices. JAX is imported only inside the
reference helpers, so the spawned ranks, which import this module to find
their function, do not load it. Every step runs the full-width twin at
dropout 0, on batches of 2 crops of 8 frames from bank items of 16 (the
twin costs about 2.5 GFLOP a frame, so the file takes about a minute on
the CPU). At 4 frames the pulses saturate (cosines 1 - 1e-6) and the
gradients are rounding noise.

Tolerances:
- ``ntxent_global``: loss and positive / negative cosines 1e-5 relative,
  against JAX ``ntxent_global`` under shard_map and against ``ntxent`` on
  the global batch; gradients w.r.t. anchors and positives 1e-6 absolute
  (tests/test_ntxent.py);
- the host-batch sharded step, against the port's unsharded step and JAX's
  ``make_train_step(mesh)``: loss and positive cosine 2e-4 relative plus
  1e-5, parameters after one step 5e-6 (tests/test_train.py); against the
  unsharded step also the gradients, 1e-3 of each tensor's largest;
- the staged track-parallel step (d = 2, k = 2), against the port's
  single-device k = 4 step: loss and cosines 1e-5 relative, parameters
  2e-6 (tests/test_pretext_track_parallel.py), gradients within 1e-3 of
  each tensor's largest; against JAX's mesh step: loss and cosines 1e-5
  relative, gradients (JAX's over d, below) 1e-3 of each tensor's largest,
  parameters 2 lr plus their float32 rounding (tests/test_torch_pretext.py);
- the ranks against each other, and a one-rank mesh's staged step against
  no mesh (dropout on): exact; its host-batch step, whose NT-Xent is
  ``ntxent_global`` (a 2-D matmul where ``ntxent`` runs a batched one):
  loss and cosines 1e-6 relative, gradients 1e-5 of each tensor's largest.
"""

import contextlib
import functools
import io
import json
import os
import time

import numpy as np
import pytest
import torch

from zeronotesamba_torch import cli
from zeronotesamba_torch.experiments import pretext_driver as pdrv
from zeronotesamba_torch.losses.ntxent import ntxent, ntxent_global
from zeronotesamba_torch.models.encoder import DSCNN
from zeronotesamba_torch.models.weights import state_dict_from_jax
from zeronotesamba_torch.parallel import mesh as pmesh
from zeronotesamba_torch.parallel.launch import run_ranks, single_rank
from zeronotesamba_torch.train.checkpoint import load_params
from zeronotesamba_torch.train.pretext import (
    PretextConfig,
    crop_shifts,
    init_pretext_state,
    make_staged_train_step,
    make_train_step,
)

torch.set_num_threads(2)

WORLD = 2
B, CROP, FRAMES = 2, 8, 16
K = 2  # tracks a rank in the staged step
SHARD = 3  # staged-step bank tracks a rank
INIT_KEY = 1
TEMP = 0.25
EPS = float(np.finfo(np.float32).eps)


def _bank(n, frames, seed):
    return (np.random.default_rng(seed).standard_normal((n, 2, 96, frames)) * 4.0 - 6.0).astype(np.float32)


def _cfg(**kw):
    return PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0, **kw)


def _inputs(twin):
    g = np.random.default_rng(5)
    local = g.integers(0, SHARD, size=(WORLD, K))
    return dict(
        twin=twin,
        ntx_a=g.standard_normal((4 * WORLD, 32)).astype(np.float32),
        ntx_p=g.standard_normal((4 * WORLD, 32)).astype(np.float32),
        batch=crop_shifts(_bank(1, FRAMES, seed=2)[0], B, CROP, g),
        bank=_bank(WORLD * SHARD, FRAMES, seed=0),
        local=local.reshape(-1),
        global_idx=(np.arange(WORLD)[:, None] * SHARD + local).reshape(-1),
        starts=g.integers(0, FRAMES - CROP + 1, size=(WORLD * K, B)),
    )


def _np_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _np_grads(model):
    return {k: p.grad.numpy().copy() for k, p in model.named_parameters()}


def _rank_checks(mesh, inp):
    """Every port-side check on one rank of the two-rank world."""
    torch.set_num_threads(1)
    out = {"shape": dict(mesh.shape), "rank": mesh.rank, "size": mesh.size, "device": str(mesh.device)}
    errors = {}
    for name, call in (("data1", lambda: pmesh.make_mesh(data=1)), ("model2", lambda: pmesh.make_mesh(model=2)),
                       ("time2", lambda: pmesh.make_mesh(data=1, time=2)),
                       ("rows3", lambda: pmesh.shard_batch(mesh, np.zeros((3, 2))))):
        try:
            call()
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = (type(e).__name__, str(e))
    out["errors"] = errors
    out["generator_seed"] = pmesh.rank_generator(torch.Generator().manual_seed(3), mesh.rank).initial_seed()
    shared = pmesh.host_array_from_rank0(np.arange(12.0).reshape(4, 3) if mesh.rank == 0 else None, mesh)
    out["shared"] = dict(type=type(shared).__name__, value=np.array(shared),
                         filename=shared.filename if isinstance(shared, np.memmap) else None)

    a, p = pmesh.shard_batch(mesh, inp["ntx_a"], inp["ntx_p"])
    a.requires_grad_(True)
    p.requires_grad_(True)
    loss, pc, nc = ntxent_global(a, p, TEMP, mesh.group)
    loss.backward()
    out["ntx"] = dict(values=[loss.item(), pc.item(), nc.item()], a_grad=a.grad.numpy(), p_grad=p.grad.numpy())

    state = init_pretext_state(_cfg(), 0, params=inp["twin"], device="cpu")
    state, loss, pc, nc = make_train_step(_cfg(), mesh)(state, torch.tensor(inp["batch"]), None)
    out["host"] = dict(values=[loss.item(), pc.item(), nc.item()], params=_np_state(state.model),
                       grads=_np_grads(state.model))

    state = init_pretext_state(_cfg(), 0, params=inp["twin"], device="cpu")
    shard = pmesh.shard_batch(mesh, inp["bank"])
    state, loss, pc, nc = make_staged_train_step(_cfg(), mesh)(state, shard, inp["local"], inp["starts"], None)
    out["staged"] = dict(values=[loss.item(), pc.item(), nc.item()], params=_np_state(state.model),
                         grads=_np_grads(state.model), shard_rows=len(shard))

    # The pretext subcommand's body, as each launched rank runs it, at an
    # 8-frame crop (test_cli_data_parallel_on_cpu says why).
    config = pdrv.PretextRunConfig
    pdrv.PretextRunConfig = functools.partial(config, crop_frames=CROP)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            cli._pretext(mesh, cli.build_parser().parse_args(inp["cli_argv"]))
    finally:
        pdrv.PretextRunConfig = config
    out["cli_stdout"] = printed.getvalue()
    return out


@pytest.fixture(scope="module")
def twin():
    """The JAX TwinPretext's initial params (numpy), dropout 0."""
    import jax

    from zeronotesamba_tpu.train import pretext as jpre

    state = jpre.init_pretext_state(jpre.PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0),
                                    jax.random.PRNGKey(INIT_KEY))
    return jax.tree_util.tree_map(np.asarray, state.params)


@pytest.fixture(scope="module")
def inputs(twin):
    return _inputs(twin)


@pytest.fixture(scope="module")
def cli_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    full = _bank(4, FRAMES, seed=4)
    np.savez(d / "bank.npz", train_bank=full[:3], val_bank=full[3:])
    return d


@pytest.fixture(scope="module")
def ranks(inputs, cli_dir):
    argv = ["pretext", "--bank", str(cli_dir / "bank.npz"), "--task", "clmr", "--epochs", "1", "--batch-size", "2",
            "--checkpoint", str(cli_dir / "mesh.pth"), "--data-parallel"]
    return run_ranks(_rank_checks, WORLD, "gloo", dict(inputs, cli_argv=argv), timeout_s=600)


def _jax_mesh():
    import jax

    from zeronotesamba_tpu.parallel.mesh import make_mesh

    return make_mesh(data=WORLD, devices=jax.devices()[:WORLD])


def _jax_state(twin, lr, record=False):
    """A JAX TrainState of the dropout-0 twin at ``twin``, Adam at ``lr``;
    with ``record``, opt_state[0] keeps the gradients of the last step."""
    import jax
    import jax.numpy as jnp
    import optax

    from zeronotesamba_tpu.train import pretext as jpre
    from zeronotesamba_tpu.train.state import TrainState

    tx = optax.adam(lr, b1=0.9, b2=0.999)
    if record:
        keep = optax.GradientTransformation(lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
                                            lambda g, s, p=None: (g, g))
        tx = optax.chain(keep, tx)
    return TrainState.create(apply_fn=jpre.make_pretext_model("zerons", 0.0).apply, params=twin, tx=tx)


def _assert_ranks_agree(ranks, part, keys=("params",)):
    for key in keys:
        for name, v in ranks[0][part][key].items():
            np.testing.assert_array_equal(ranks[1][part][key][name], v, err_msg=f"{part} {key} {name}")
    assert ranks[0][part]["values"] == ranks[1][part]["values"]


def _assert_grads_close(got: dict, ref: dict, rel=1e-3):
    for name, g_ref in ref.items():
        np.testing.assert_allclose(got[name], g_ref, rtol=0, atol=rel * np.abs(g_ref).max(), err_msg=name)


def test_make_mesh_sizes_and_refusals(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["shape"] == {"data": 2, "time": 1, "model": 1} and r["size"] == 2 and r["device"] == "cpu"
        assert r["errors"]["data1"] == ("ValueError", "mesh 1x1x1 != 2 devices")  # the JAX text
        for name in ("model2", "time2"):
            assert r["errors"][name][0] == "NotImplementedError" and "item 10" in r["errors"][name][1]
        assert r["errors"]["rows3"][0] == "ValueError"
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh()
    with single_rank("gloo", "cpu") as mesh:
        assert mesh.shape == {"data": 1, "time": 1, "model": 1} and mesh.rank == 0
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="mesh 2x1x1 != 1 devices"):
            pmesh.make_mesh(data=2)
        x = np.arange(6.0).reshape(3, 2)
        np.testing.assert_array_equal(pmesh.batch_sharding(mesh)(x).numpy(), x)
        a, b = pmesh.shard_batch(mesh, x, x[:1])
        assert a.shape == (3, 2) and b.shape == (1, 2)
        assert pmesh.host_array_from_rank0(x, mesh) is x
    assert not torch.distributed.is_initialized()


def test_host_array_from_rank0(ranks):
    """Rank 0 keeps its array; rank 1 maps rank 0's file, which is gone once
    both ranks hold the array."""
    expect = np.arange(12.0).reshape(4, 3)
    assert ranks[0]["shared"]["type"] == "ndarray" and ranks[1]["shared"]["type"] == "memmap"
    for r in ranks:
        np.testing.assert_array_equal(r["shared"]["value"], expect)
    assert ranks[1]["shared"]["filename"] and not os.path.exists(ranks[1]["shared"]["filename"])


def test_rank_dropout_streams(ranks):
    """Rank 0 keeps the step's generator; rank 1 draws from another seed."""
    assert ranks[0]["generator_seed"] == 3 and ranks[1]["generator_seed"] != 3
    assert pmesh.rank_generator(None, 1) is None


def test_ntxent_global_matches_jax_and_the_global_batch(ranks, inputs):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from zeronotesamba_tpu.losses.ntxent import ntxent_global as j_global

    a_np, p_np = inputs["ntx_a"], inputs["ntx_p"]
    a, p = torch.tensor(a_np, requires_grad=True), torch.tensor(p_np, requires_grad=True)
    loss, pc, nc = ntxent(a, p, TEMP)
    loss.backward()
    ref = [loss.item(), pc.item(), nc.item()]

    fn = jax.shard_map(lambda x, y: j_global(x, y, TEMP, "data"), mesh=_jax_mesh(), in_specs=(P("data"), P("data")),
                       out_specs=(P(), P(), P()))
    j_vals = [float(v) for v in jax.jit(fn)(jnp.asarray(a_np), jnp.asarray(p_np))]
    j_ga, j_gp = jax.jit(jax.grad(lambda x, y: fn(x, y)[0], argnums=(0, 1)))(jnp.asarray(a_np), jnp.asarray(p_np))

    assert ranks[0]["ntx"]["values"] == ranks[1]["ntx"]["values"]
    got = ranks[0]["ntx"]["values"]
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(got, j_vals, rtol=1e-5)
    g_a = np.concatenate([r["ntx"]["a_grad"] for r in ranks])
    g_p = np.concatenate([r["ntx"]["p_grad"] for r in ranks])
    for g, t_ref, j_ref in ((g_a, a.grad.numpy(), j_ga), (g_p, p.grad.numpy(), j_gp)):
        np.testing.assert_allclose(g, t_ref, atol=1e-6)
        np.testing.assert_allclose(g, np.asarray(j_ref), atol=1e-6)


def test_sharded_host_step_matches_unsharded_and_jax(ranks, inputs, twin):
    import jax
    import jax.numpy as jnp

    from zeronotesamba_tpu.train import pretext as jpre

    _assert_ranks_agree(ranks, "host", ("params", "grads"))
    got = ranks[0]["host"]
    state = init_pretext_state(_cfg(), 0, params=twin, device="cpu")
    state, loss, pc, nc = make_train_step(_cfg())(state, torch.tensor(inputs["batch"]), None)
    np.testing.assert_allclose(got["values"][:2], [loss.item(), pc.item()], rtol=2e-4, atol=1e-5)
    for name, v in _np_state(state.model).items():
        np.testing.assert_allclose(got["params"][name], v, atol=5e-6, err_msg=name)
    _assert_grads_close(got["grads"], _np_grads(state.model))

    jcfg = jpre.PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0)
    j_state = _jax_state(twin, state.optimizer.param_groups[0]["lr"])
    new, j_loss, j_pc, _ = jpre.make_train_step(jcfg, _jax_mesh())(j_state, jnp.asarray(inputs["batch"]),
                                                                  jax.random.PRNGKey(7))
    np.testing.assert_allclose(got["values"][:2], [float(j_loss), float(j_pc)], rtol=2e-4, atol=1e-5)
    j_params = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new.params))
    for name, v in j_params.items():
        np.testing.assert_allclose(got["params"][name], v.numpy(), atol=5e-6, err_msg=name)


def test_track_parallel_step_matches_single_device_k4(ranks, inputs, twin):
    _assert_ranks_agree(ranks, "staged", ("params", "grads"))
    got = ranks[0]["staged"]
    assert got["shard_rows"] == SHARD
    state = init_pretext_state(_cfg(), 0, params=twin, device="cpu")
    state, loss, pc, nc = make_staged_train_step(_cfg())(state, torch.tensor(inputs["bank"]), inputs["global_idx"],
                                                         inputs["starts"], None)
    np.testing.assert_allclose(got["values"], [loss.item(), pc.item(), nc.item()], rtol=1e-5)
    for name, v in _np_state(state.model).items():
        np.testing.assert_allclose(got["params"][name], v, atol=2e-6, err_msg=name)
    _assert_grads_close(got["grads"], _np_grads(state.model))


def test_track_parallel_step_matches_jax_mesh_step(ranks, inputs, twin):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from zeronotesamba_tpu.train import pretext as jpre

    lr = init_pretext_state(_cfg(), 0, params=twin, device="cpu").optimizer.param_groups[0]["lr"]
    mesh = _jax_mesh()
    step = jpre.make_staged_train_step(jpre.PretextConfig(batch_size=B, crop_frames=CROP, dropout_rate=0.0), mesh)
    new, loss, pc, nc = step(_jax_state(twin, lr, record=True), jax.device_put(inputs["bank"], NamedSharding(mesh, P("data"))),
                             jnp.asarray(inputs["local"], jnp.int32), jnp.asarray(inputs["starts"], jnp.int32),
                             jax.random.key(0))
    got = ranks[0]["staged"]
    np.testing.assert_allclose(got["values"], [float(loss), float(pc), float(nc)], rtol=1e-5)
    to_sd = lambda t: {k: v.numpy() for k, v in state_dict_from_jax(jax.tree_util.tree_map(np.asarray, t)).items()}  # noqa: E731
    # JAX's mesh step hands Adam d times the gradient of its mean loss: inside
    # shard_map the gradient w.r.t. the replicated params arrives summed over
    # the devices, and the explicit pmean keeps that sum. Adam's first step
    # is the same at any gradient scale (up to its eps), so the parameters
    # agree. The port applies the mean loss's gradient, which is the
    # single-device k' = d*k step's (test above).
    _assert_grads_close({k: WORLD * g for k, g in got["grads"].items()}, to_sd(new.opt_state[0]))
    for name, v in to_sd(new.params).items():
        np.testing.assert_allclose(got["params"][name], v, rtol=2 * EPS, atol=2 * lr, err_msg=name)


def test_one_rank_mesh_equals_no_mesh_with_dropout():
    """Rank 0 of a mesh draws the single-device dropout masks, so a world of
    one rank takes the single-device staged step exactly, dropout on."""
    from zeronotesamba_torch.train.supervised import dropout_generator

    cfg = PretextConfig(batch_size=B, crop_frames=CROP, lr=1e-4)
    bank = torch.tensor(_bank(3, FRAMES, seed=0))
    starts = np.random.default_rng(1).integers(0, FRAMES - CROP + 1, size=(2, B))
    batch = bank[:, :, :, :CROP].repeat(2, 1, 1, 1)[:B]
    with single_rank("gloo", "cpu") as mesh:
        runs = []
        for m in (None, mesh):
            state = init_pretext_state(cfg, 0, device="cpu")
            staged = make_staged_train_step(cfg, m)(state, bank, np.array([0, 2]), starts, dropout_generator(1, 0, "cpu"))
            staged = ([v.item() for v in staged[1:]], _np_state(state.model))
            state = init_pretext_state(cfg, 0, device="cpu")
            host = make_train_step(cfg, m)(state, batch, dropout_generator(1, 1, "cpu"))
            runs.append((staged, [v.item() for v in host[1:]], _np_grads(state.model)))
    (s0, h0, g0), (s1, h1, g1) = runs
    assert s0[0] == s1[0]
    for name, v in s0[1].items():
        np.testing.assert_array_equal(s1[1][name], v, err_msg=name)
    np.testing.assert_allclose(h1, h0, rtol=1e-6)
    _assert_grads_close(g1, g0, rel=1e-5)


def _fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 would wait here for ever


def test_run_ranks_raises_when_a_rank_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 raised.*rank 1 fails on purpose"):
        run_ranks(_fail_on_rank_1, WORLD, "gloo", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_cli_data_parallel_on_two_ranks(ranks, cli_dir):
    """``pretext --data-parallel`` on two ranks: rank 0 alone reads the
    bank, prints its line and writes the checkpoint; rank 1 trains on the
    train bank it maps from rank 0's file."""
    line = json.loads(ranks[0]["cli_stdout"])
    assert line["ranks"] == 2 and line["epochs"] == 1 and np.isfinite(line["best_val_loss"])
    assert ranks[1]["cli_stdout"] == ""
    assert sorted(os.listdir(cli_dir)) == ["bank.npz", "mesh.pth"]
    assert sorted(load_params(str(cli_dir / "mesh.pth"))) == sorted(DSCNN().state_dict())


def _slow_rank(mesh, rounds):
    t = torch.zeros(1)
    for _ in range(rounds):
        time.sleep(1.0)
        torch.distributed.all_reduce(t)
    return mesh.rank


def test_run_ranks_outlives_its_collective_timeout():
    """The collective timeout bounds one wait in a collective, not the run:
    ranks whose collectives each wait far less than it run longer than it in
    all, and a run has no time limit unless its caller sets one."""
    t0 = time.monotonic()
    assert run_ranks(_slow_rank, WORLD, "gloo", 6, collective_timeout_s=5.0) == [0, 1]
    assert time.monotonic() - t0 > 5.0


def test_run_ranks_stops_at_its_time_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="within 3"):
        run_ranks(_slow_rank, WORLD, "gloo", 60, timeout_s=3)
    assert time.monotonic() - t0 < 30


def test_cli_data_parallel_on_cpu(tmp_path, capsys, monkeypatch):
    """``pretext --data-parallel --device cpu``: one gloo rank in this
    process (the one-rank mesh's equality with no mesh is held above). The
    CLI's 313-frame crop is cut to 8 frames here: the full width costs
    about 20 s an update on the CPU."""
    monkeypatch.setattr(pdrv, "PretextRunConfig", functools.partial(pdrv.PretextRunConfig, crop_frames=CROP))
    bank = str(tmp_path / "bank.npz")
    full = _bank(2, FRAMES, seed=4)
    np.savez(bank, train_bank=full[:1], val_bank=full[1:])
    ckpt = str(tmp_path / "mesh.pth")
    cli.main(["pretext", "--bank", bank, "--task", "clmr", "--epochs", "1", "--batch-size", "2",
              "--checkpoint", ckpt, "--device", "cpu", "--data-parallel"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert line["checkpoint"] == ckpt and line["ranks"] == 1 and line["epochs"] == 1
    assert np.isfinite(line["best_val_loss"]) and line["restarts"] == []
    assert sorted(load_params(ckpt)) == sorted(DSCNN().state_dict())  # the reference DS_CNN keys
    assert not torch.distributed.is_initialized()
