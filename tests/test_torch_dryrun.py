"""The port's entry hooks (zeronotesamba_torch/parallel/dryrun.py) against
the JAX package's ``__graft_entry__``: ``entry()``'s forward with the JAX
entry's params on the JAX entry's inputs, 1e-5 relative (conftest puts the
repo root on the import path, as tests/test_graft.py does), and
``dryrun_multichip(4)`` on four gloo ranks on the CPU, every stage to its end
(each stage holds its own parity limits, those of the JAX dry run).
"""

import numpy as np
import pytest
import torch

from zeronotesamba_torch.models.weights import state_dict_from_jax
from zeronotesamba_torch.parallel.dryrun import _factorizations, dryrun_multichip, entry

torch.set_num_threads(2)


def test_entry_matches_jax_entry():
    import jax

    import __graft_entry__ as g

    jfn, (jparams, janc, jpos) = g.entry()
    ref = np.asarray(jax.jit(jfn)(jparams, janc, jpos))
    fn, (params, anc, pos) = entry(device="cpu")
    assert set(params) == set(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams)))
    for got, want in ((anc, janc), (pos, jpos)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    out = fn(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams)), anc, pos)
    assert out.shape == (2, 313) and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    assert np.all(np.isfinite(fn(params, anc, pos).numpy()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry()


def test_factorizations_are_the_jax_default_sweep():
    import __graft_entry__ as g

    for n in (2, 4, 6, 8):
        assert _factorizations(n) == g._factorizations(n, full=False)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 16])
def test_factorizations_are_the_jax_sweeps(n, full):
    """Both JAX sweeps, the default and ZNS_DRYRUN_FULL's; with the full
    sweep the pretext stage draws three batches, the JAX dry run's count,
    before the bank."""
    import __graft_entry__ as g

    from zeronotesamba_torch.parallel.dryrun import _inputs

    assert _factorizations(n, full) == g._factorizations(n, full)
    assert max(k for *_, k in _factorizations(n, full)) == len(_inputs(2, full)["batches"])


def test_dryrun_multichip_4_on_cpu_gloo_ranks():
    laps = dryrun_multichip(4, device="cpu")
    assert [lap["stage"] for lap in laps] == ["references", "pretext", "pretext", "track", "supervised", "tp"]
    assert laps[-1]["msg"].endswith("dryrun complete")
    assert [lap["msg"].split(":")[0] for lap in laps[1:3]] == ["pretext 2-step trajectory on mesh 4x1x1",
                                                              "pretext 1-step trajectory on mesh 1x2x2"]
    with pytest.raises(ValueError, match="even number"):
        dryrun_multichip(3, device="cpu")
