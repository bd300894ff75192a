"""entry() compiles and runs; dryrun_multichip executes the sharded fleet
step on the virtual CPU mesh."""

import jax
import numpy as np

import __graft_entry__ as graft
import pytest


@pytest.mark.slow
def test_entry_compiles_and_runs():
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert out.poses.shape == (4096, 3)
    assert int(out.n_active) >= 1
    w = np.asarray(out.weights)
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-5)


@pytest.mark.slow
def test_dryrun_multichip_8():
    graft.dryrun_multichip(8)


@pytest.mark.slow
def test_dryrun_multichip_2():
    graft.dryrun_multichip(2)
