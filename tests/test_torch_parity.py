"""utils/parity.PiecewiseDecisions on the CPU: a replay takes the recorded
max-pool argmaxes and ReLU signs, reproduces the recorded step exactly, and
refuses a record that does not match the forward passes it replays."""

import numpy as np
import pytest
import torch

from zeronotesamba_torch.train.pretext import PretextConfig, init_pretext_state, make_staged_train_step
from zeronotesamba_torch.utils.parity import PiecewiseDecisions

torch.set_num_threads(2)

CFG = PretextConfig(batch_size=2, crop_frames=16, dropout_rate=0.0, lr=1e-4)


def _bank(seed):
    return torch.tensor((np.random.default_rng(seed).standard_normal((2, 2, 96, 32)) * 4.0 - 6.0).astype(np.float32))


def _step(bank, ctx=None):
    state = init_pretext_state(CFG, 0, device="cpu")
    step = make_staged_train_step(CFG)
    if ctx is None:
        _, loss, _, _ = step(state, bank, np.array([0, 1]), np.array([[0, 9], [3, 16]]), None)
    else:
        with ctx:
            _, loss, _, _ = step(state, bank, np.array([0, 1]), np.array([[0, 9], [3, 16]]), None)
    return loss.item(), {k: v.grad.clone() for k, v in state.model.named_parameters()}


def test_replay_reproduces_the_recorded_step():
    rec = PiecewiseDecisions()
    loss, grads = _step(_bank(0), rec.record())
    assert [k for k, _ in rec.log] == (["relu", "pool", "relu"] * 3 + ["relu"] * 2) * 2  # two encoders
    again, replayed = _step(_bank(0), rec.replay())
    assert again == loss
    for k in grads:
        torch.testing.assert_close(replayed[k], grads[k], rtol=0, atol=0, msg=k)


def test_replay_takes_the_recorded_decisions_on_other_inputs():
    rec_a, rec_b = PiecewiseDecisions(), PiecewiseDecisions()
    _step(_bank(0), rec_a.record())
    loss_b, grads_b = _step(_bank(1), rec_b.record())
    assert rec_a.differing(rec_b) > 0
    loss_ab, grads_ab = _step(_bank(1), rec_a.replay())
    assert loss_ab != loss_b
    assert any(not torch.equal(grads_ab[k], grads_b[k]) for k in grads_b)


def test_replay_refuses_a_record_of_other_forward_passes():
    rec = PiecewiseDecisions()
    with rec.record():
        _step(_bank(0))
        _step(_bank(0))
    with pytest.raises(RuntimeError, match="unused"):
        _step(_bank(0), rec.replay())
    with pytest.raises(ValueError, match="different forward passes"):
        rec.differing(PiecewiseDecisions())
